#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bsyolo_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (PATH or $CUDA_HOME/bin), a host C++ compiler and
this checkout; exits non-zero without them. Phases, each of which fails the run on its own:

1. the card's name and power limit; every kernel of the port built with
   nvcc from ``bsyolo_tpu_torch/kernels/csrc``, and the JPEG codec with the
   host C++ compiler, one compiler per source, all at once;
2. each kernel against its plain PyTorch version on the card, at the shapes
   its paths give it and at ragged ones, with its time, the plain version's
   time, the least time the card could take (bytes or operations over the
   card's published peak) and, for the decode kernels, the host time per call
   in turns with the plain version; both decode kernels also on bfloat16 and
   float16 levels (the predict shape, B 4 at 640 px, and a P6 pyramid whose
   5 x 5 level has odd H * W) against the plain version on the same levels,
   timed at the predict shape beside their 2-byte bound;
3. the predict path at full yolo11n width (nc 12, imgsz 640), seeded random
   weights, 8 seeded synthetic frames (480x640 and 720x1280), batch 1 and
   batch 4, conf 0.001: the box-best decode kernel launched once per batch,
   throughput, and detections held against the same port on the CPU; the
   decode stage on the head maps the path made runs one device kernel per
   call, the decode kernel, and its device and host time per call;
4. the test-time-augmented predict path (``predict(augment=True)``) on the
   same frames at batch 4: the xywh decode kernel launched three times per
   batch, throughput, and detections held against the CPU; the decode stage
   of each pass as in phase 3;
5. the tiled (SAHI-style) path, ``predict_tiled`` with 640-px tiles on a
   seeded 1080x1920 frame (8 tiles) and a 720x1280 frame (6 tiles): the xywh
   decode kernel launched once per call, time per frame, and detections held
   against the CPU; the decode stage as in phase 3;
6. int8 predict on the same frames at batch 4: ``calibrate_int8`` on the card,
   static int8 (the int8 matmul kernel launched once per quantizable conv,
   74 times per batch), throughput, float and int8 in turns, head maps against
   float, every int8 conv held against its CPU twin on the same input, and
   detections held against the port's int8 on the CPU with the same scales;
   one batch in dynamic int8 and one in float; then the kernel, its plain
   version and ``torch._int_mm`` timed over the 74 products of one forward,
   with the kernel's tile at each, its host time per call, and the share of
   the device time that is not the kernel (which must be 0: the operands are
   laid out as the conv path lays them out, so the wrapper copies nothing);
   the same 74 products through the kernel's bf16 epilogue beside
   ``torch._int_mm`` with a dequantization to bf16, and their bound with
   bf16 output. Phase 2 also holds the box decode kernel on the heads of
   real forwards of yolo11n-seg (nc 80, 32 mask coefficients: 176 channels
   per anchor) and yolo11n-pose (nc 1, 17 x 3 keypoints: 116), where it
   must step over the channels past the class logits; phase 3 also times
   plain predict at batch 4 with the predictor's letterbox (OpenCV's integer
   INTER_LINEAR) and the earlier bilinear one in turns, and holds the
   letterbox on the card byte-equal to the CPU's.

7. the train step at the same width (``make_train_step``, SGD, lr0 0.01, nbs
   64, the default warmup), on seeded synthetic batches in the padded-label
   contract (uint8 frames with 1 to 4 filled rectangles, one colour per
   class, 8 label rows): (a) one step at batch 4 from the same weights and
   batch on the card and on the port's CPU path, the loss items, each
   tensor's gradient, and the params, EMA, BatchNorm statistics and momentum
   buffers after the step held against the CPU; (b) 30 steps at batch 16 on
   the card on a repeated batch, the accumulation count rising from 1 to 2
   within the run: every ``updated`` flag against the host's rule, every loss
   finite, the last 5 steps' mean loss below the first 5's; ms per step,
   img/s, the device busy share over 10 profiled steps and the peak memory;
   no kernel of the port launched;
8. the detect validator (``DetectionValidator``) over the EMA parameters of
   7b and the model's live BatchNorm statistics, on 4 seeded val batches of 8
   at two canvas shapes (640x640 and 384x640), the last batch ending in
   padding rows: the box decode kernel launched once per batch and its plain
   version never, mAP50, mAP50-95, P and R held against the port's validator
   on the CPU with the same weights and batches, and each batch's detections
   held against the CPU's; ms per image.
9. the trainer and the facade at full width: a seeded synthetic PNG dataset
   (64 train and 16 val 480x640 frames, 1 to 4 filled rectangles each, one
   colour per class, the 12 car.yaml classes) written to a temporary
   directory; ``YOLO("yolo11n.yaml").train(epochs=2, close_mosaic=1, imgsz
   640, batch 16, amp=False, plots=False, workers=4, seed=3)`` (mosaic in
   epoch 0, none in epoch 1), then ``train(resume=True, epochs=3)`` (epoch 2
   only), then ``YOLO(best.ckpt).val(batch=16)`` and ``.predict`` of phase
   3's frames: the box decode kernel launched once per validation batch and
   per predict batch and its plain version never; the first batch the card
   trainer's step received equal, byte for byte, to the CPU loader's at the
   same seed and epoch; finite loss items; ``last.ckpt`` reloading into the
   trainer's parameters exactly; ms per step, img/s and the loader-wait share
   per epoch, and over the epochs after each run's first (whose spawned
   workers start up); peak memory, validation ms per image.
10. the bf16 graph (``half`` and ``amp``), at the same width: (a)
   ``predict(half=True)`` at batch 4 over phase 3's frames: the head levels
   bfloat16, the box decode kernel once per batch on them and no plain
   decode; float32 and bf16 in turns, device work and busy share; the
   kernel's device time on that head beside its bound; the bf16 head on the
   card against the CPU's, and the decoded box and best logit of every
   anchor against the CPU's (the rows after NMS are printed only); (b) TTA
   (three xywh decodes per batch) and ``predict_tiled`` on ``half_graph()``
   (one per call) on bf16 levels; (c) int8 on the half graph: the int8
   matmul kernel 74 times per forward through its bf16 epilogue (the
   profiler's kernel names), rows against the CPU's as in phase 6; (d) the
   amp train step: its gradient at batch 4 against phase 7a's float64
   referee, phase 7b's 30 steps on the bf16 graph beside 7b's figures, and
   float32 and amp steps in turns; (e) ``YOLO("yolo11n.yaml").train`` with
   its default ``amp=True`` on phase 9's dataset, 2 epochs at batch 16,
   then ``YOLO(best.ckpt).val(half=True)``: the box decode kernel once per
   validation batch on bf16 levels, ms per step of epoch 1, the loader-wait
   share, peak memory.

11. the parking-violation product path at full width: yolo11n (nc 12,
   imgsz 640, ``draw_weights``) and the application's GRFB-UNet segmenter
   (base_c 32, 2 classes, short side 565; seeded weights, the second class's
   bias balanced on the background frame), on a seeded synthetic 720x1280
   clip of 48 frames at a 25 fps video clock (a grey road with a yellow strip
   of tactile paving, three moving rectangles, one of which stops across the
   strip; frame 0 empty, through ``prepare_background``): (a) the segmenter
   on 4 frames on the card and on the CPU, its input equal, its logits on the
   same input and its masks held to the CPU's; (b) the pipeline's decision
   step (``ParkingViolationPipeline.decide``: ``YOLO.track`` with ByteTrack
   at conf 0.25, the segmenter, the occlusion rule, the dwell timer) over the
   clip on the card: the box decode kernel once per frame and its plain
   version never, well-formed events, tracked rows on most frames; ms per
   frame split into track, segment and rule, the device busy share over the
   clip and peak memory; (c) its first 8 frames against the port on the
   CPU: the detections before tracking paired as in phase 3, then the ids:
   tracked rows paired with the same ids, or a replay of the card's
   detections through a fresh CPU tracker; (d) ``YOLO.track`` with
   BoT-SORT (ReID on, no camera-motion compensation) over 8 frames,
   ``persist=True``: the decode kernel once per frame.

12. real photos, the ``tests/fixtures/bsyolo8`` JPEGs: (a) the port's JPEG
   decoder (host C++, ``kernels/csrc/jpeg.cpp``, built with the host
   compiler beside the kernels) over the 8 photos, each array against a
   committed SHA-256 digest of ``cv2.imread``'s; (b) its encoder at quality
   95 against digests of ``cv2.imencode``'s bytes; the host ms per photo, the
   compiler's version and whether OpenCV is importable; (c) ``YOLO.train`` of
   full-width yolo11n (imgsz 320, 2 epochs, batch 8, 2 workers) on a train
   list of the photos 16 times over (16 steps per epoch, ms per step and the
   loader-wait share per epoch), validated on the 8 photos, the box decode
   kernel once per validation batch, then ``val(save_json=True,
   save_txt=True)``: one label file per photo and a ``predictions.json`` over
   the 8 image ids, one launch; (d) ``predict(save_txt=True, save_crop=True)``
   of the photos' directory at 640 px, batch 4, through the predictor's
   reader thread, one launch per batch, against the same call on the CPU
   (rows paired as in phase 3), the label and crop files against the
   detections; then the rate over a directory of the photos 64 times over
   (128 batches, one launch each): from files through the reader thread,
   against the same frames decoded beforehand (no decode) and against
   decoding each batch and then running it in one thread (no reader thread),
   in turns, with img/s and the share of the wall time spent waiting on the
   reader; ``embed`` against the CPU's.

13. the Segment and Pose task heads at full width: yolo11n-seg (nc 80) and
   yolo11n-pose (nc 1, 17 x 3 keypoints, COCO's flip_idx), each on a seeded
   JPEG dataset (32 train and 8 val 480x640 frames written by the port's
   encoder: filled polygons, or boxes with 17 keypoints): (a) one train step
   at batch 2 from the same drawn weights and loader batch, card against
   CPU, the loss items held within 1e-3; (b) ``YOLO.train`` 2 epochs at
   batch 8 with 2 workers, ``YOLO(best.ckpt)`` rebuilding the task's head,
   ``val`` and ``predict`` (segment with and without ``retina_masks``): the
   box decode kernel once per validation and predict batch and its plain
   version never; ms per step, loader-wait share, peak memory; (c) predict
   at conf 0.25 on drawn weights: head maps and prototypes against the
   CPU's, rows against the CPU's predictor run on the card's head maps
   (paired at least 0.98), the paired rows' masks (mean IoU at least 0.99)
   or keypoints (within 0.05 px), the CPU's own graph paired and printed;
   ms per batch of 4 and ``process_mask``'s device time.

14. The OBB and Classify task families at full width: yolo11n-obb (nc 15,
   DOTA's classes) at 1024 px on a seeded set of 32 train and 8 val
   1024x1024 JPEGs of rotated rectangles, and yolo11n-cls (nc 10, the
   folder-per-class set of 10 x 16 train and 10 x 4 val JPEGs) at 224 px:
   (a) one train step from the same drawn weights and loader batch (OBB at
   batch 2, classify at batch 8), card against CPU, loss items within 1e-3;
   (b) ``YOLO.train`` 2 epochs with 2 workers (OBB at batch 4, classify at
   batch 32), ``YOLO(best.ckpt)`` rebuilding the head with the data's
   classes, ``val`` and ``predict``: ms per step, loader-wait share, peak
   memory; (c) predict at conf 0.25 and batch 4 on drawn weights: the OBB
   head maps against the CPU's, the rotated rows against the CPU's
   postprocess run on the card's head maps (paired at least 0.98, within
   1e-3 px and 1e-5 rad), yolo11n-cls at nc 1000 (ImageNet's classes) with
   its top 5 equal to the CPU's and probabilities within 1e-5; ms per batch
   of 4. These paths reach no kernel of the port: every launch counter stays
   0 through them, and phase 14 checks that.

15. The bf16 graph and int8 on those four task graphs, on phases 13's and
   14's datasets: (a) one amp train step (the bf16 graph over float32
   weights) from the seeded init and a loader batch, card against CPU, loss
   items within 5e-2 and the heads bfloat16; (b) ``YOLO.train`` with its
   default amp, 1 epoch, the trainer's and the facade's graph bf16, the box
   decode kernel once per validation batch on the bf16 Segment and Pose
   heads; (c) on drawn weights: the bf16 head levels (7.5e-3 of their norm),
   prototypes (1e-2) and logits card vs CPU, ``predict(half=True)`` rows
   against the CPU's predictor on the card's head maps, ``val(half=True)``
   metrics within 0.02 of the CPU's on 4 val images; (d) ``calibrate_int8``
   on the CPU, the same scales on both: every int8 conv against its CPU twin
   on the same input, int8 predict rows as in (c), int8 ``val`` within 0.02,
   int8 on ``half_graph()``, the int8 kernel once per quantized conv per
   batch; (e) the int8 kernel over the products of one forward of each graph
   at batch 4, float32 and bf16 out, beside its bound, the plain version and
   ``torch._int_mm``; (f, in phase 9's directory) int8 ``val`` of phase 9's
   Detect checkpoint card vs CPU. Phase 2 also times the box decode kernel on
   the bf16 Segment and Pose heads. ``python3 chip_smoke.py --phase 15``
   builds the kernels and runs (a) to (e) alone, on datasets it writes.

Phases 10a to 10c run right after phase 6, on the float graph phases 3 to 6
used; 10d, 10e and 15f after phase 9, 11, 12, 13, 14 and 15 last. Each phase prints its seconds. Every launch counter is set to 0 just before a path is driven and read just
after, so each path shows the kernels it went through.

TF32 is off for convolutions and matrix products throughout, so the card and
the CPU compute the same float32 function (cuDNN would otherwise run float32
convolutions in TF32). The last two lines are the kernels JSON and
``{"ok": true, "device": {...}}``; in the kernels line each kernel carries its
launches on phase 10's bf16 paths (``bf16_launches``), on phase 11's
product path (``product_launches``) and on phase 12's photos
(``photo_launches``) among all its launches, and
``int8_matmul`` its bf16 epilogue's figures (``bf16_out``); each also carries
its launches on phase 13's and 14's task paths (``task_launches``) and on
phase 15's (``mode_launches``), ``decode_box_best`` phase 2's task-head
figures (``task_heads``, float32 and bf16), ``int8_matmul`` phase 15's
figures per task graph (``task_graphs``).
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_INT8_OPS_PER_S = 1.979e15  # dense int8 tensor-core rate

BOX_ATOL_PX = 2e-3  # kernel vs plain: float32 softmax sums in another order, times strides up to 32
SCORE_RTOL = 1e-5  # kernel vs plain sigmoid: the kernel's expf against torch.sigmoid's own exp
SEED = 0
IMGSZ = 640
CONF = 0.001
N_FRAMES = 8
HEAD_GAIN = 25.0  # scales the head's last convs so random weights give spread logits, as a trained head has
# card vs CPU detections: near-tied scores may swap rows or cross the max_det/NMS boundaries under float
# rounding of other convolution algorithms, so rows are matched, not compared in order
MATCH_BOX_PX, MATCH_SCORE, MATCH_MIN_FRACTION = 0.05, 1e-4, 0.98
# int8 card vs CPU: float layers before a quantize (cuDNN against the CPU's convolutions, BatchNorm in another
# order) differ in their last bits, and where one lands on a rounding boundary a code flips; the flip moves the
# codes after it, so scores differ by int8 noise (1e-4, not 1e-7), which reorders the dense near-tied scores of
# random weights and changes NMS and max_det decisions. Measured on an NVIDIA H100 80GB HBM3 at 700 W: 0.233 of
# the rows matched within 1 px and 1e-2 (0.024 at the float tolerances). The per-conv check holds the int8 path
# itself to float rounding.
INT8_MATCH_BOX_PX, INT8_MATCH_SCORE, INT8_MATCH_MIN_FRACTION = 1.0, 1e-2, 0.15
INT8_CONV_RTOL = 1e-5  # one int8 Conv, card vs CPU, fed the same input: the same codes, BatchNorm's order differs
# int8 matmul shapes: stem, model.3, model.28.cv2.1.0, model.1 and the largest K and N at M = 1,600 of yolo11n
# at batch 4, 640 px; the Pallas test's; a ragged one
INT8_SHAPES = ((409600, 27, 16), (25600, 576, 64), (6400, 1152, 64), (102400, 48, 64), (1600, 2304, 64),
               (1600, 512, 256), (512, 128, 128), (1000, 27, 20))


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(log: str):
    """(function, its resource lines) from nvcc's -Xptxas -v output; the int8 matmul's
    instantiations named by their tile and output type, the decode kernel's by its
    epilogue and tile."""
    import re

    report, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            tile = re.search(r"int8_matmul_kernelILi(\d+)ELi(\d+)ELi(\d+)E(f|13__nv_bfloat16)", name)
            decode = re.search(r"decode_kernelILi(\d)ELi(\d+)E", name)
            if tile:
                out = "float" if tile[4] == "f" else "bfloat16"
                name = f"int8_matmul_kernel<BM={tile[1]}, BN={tile[2]}, KB={tile[3]}, {out}>"
            elif decode:
                name = f"decode_kernel<{('box', 'xywh')[int(decode[1])]}, T={decode[2]}>"
            report.append((name, []))
        elif report and any(w in line for w in ("registers", "spill", "stack frame", "warning")):
            report[-1][1].append(line.split(":", 1)[-1].strip())
    return report


def build_kernels():
    from bsyolo_tpu_torch import kernels
    from bsyolo_tpu_torch.kernels import build

    t0 = time.perf_counter()
    names = sorted({src for _, src in kernels.KERNELS.values()}) + ["jpeg"]  # jpeg: the host JPEG codec
    build.compile_all(names)
    for name in names:
        rec = build.BUILD_LOG[name]
        src = build.source(name)
        print(f"built {src.relative_to(build.CSRC.parents[1])} (sha256 {hashlib.sha256(src.read_bytes()).hexdigest()[:16]})"
              f" in {rec['seconds']:.2f} s -> {rec['library']}")
        print(f"  {rec.get('command', '(library reused)')}")
        for function, lines in ptxas_report(rec["ptxas"]):
            print(f"  ptxas: {function}: {'; '.join(lines)}")
    print(f"build wall time {time.perf_counter() - t0:.2f} s")


def device_kernels(prof):
    """(name, device us summed, calls) of every device-side event in a profile."""
    from torch.autograd import DeviceType

    return [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def profiled(run):
    """torch.profiler (host and device) over ``run()``, then a synchronize. A session now and
    then records no device event at all; such a session is run again, up to three times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        if any(e.device_type == DeviceType.CUDA for e in prof.events()):
            break
    return prof


def repeat(fn, inputs, reps: int):
    """A function that calls ``fn(*inputs[i % len(inputs)])`` for i < reps, keeping no result."""
    def run():
        for i in range(reps):
            fn(*inputs[i % len(inputs)])
    return run


def cuda_time_ms(fn, inputs, reps: int):
    """Mean ms per call of ``fn(*inputs[i % len(inputs)])`` after warm-up: CUDA events
    around the loop (host enqueue included where it is the slower side), and the
    device time of every kernel the calls launched, from torch.profiler."""
    import torch

    repeat(fn, inputs, 3)()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    repeat(fn, inputs, reps)()
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / reps
    device_ms = sum(us for _, us, _ in device_kernels(profiled(repeat(fn, inputs, reps)))) / reps / 1e3
    return event_ms, device_ms


def bound(bytes_moved: float, ops: float, peak_ops: float):
    """(least ms the card could take, "bytes" or "operations"): the larger of bytes over
    the memory rate and operations over the peak rate for their type."""
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_against_plain(label, kernel, plain, inputs, bytes_moved, ops, peak_ops=PEAK_F32_OPS_PER_S,
                       library=None, prepare=None):
    """Time ``kernel`` and ``plain`` (and ``library`` on ``prepare``d inputs) on copies
    of ``inputs`` that together exceed the 50 MB L2, so each launch reads its first
    input (a tensor or a list of levels) from HBM; returns the kernels-line fields."""
    import torch

    def copy(t):  # laid out as the original
        return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=t.device).copy_(t)

    head = inputs[0]  # a tensor, or a list of a head's levels
    nbytes = sum(t.nbytes for t in head) if isinstance(head, list) else head.nbytes
    copies = [([copy(t) for t in head] if isinstance(head, list) else copy(head), *inputs[1:])
              for _ in range(max(2, math.ceil(120e6 / nbytes)))]
    call_ms, dev_ms = cuda_time_ms(kernel, copies, 200)
    plain_call_ms, plain_dev_ms = cuda_time_ms(plain, copies, 50)
    lib_call_ms = lib_dev_ms = None
    if library is not None:
        lib_call_ms, lib_dev_ms = cuda_time_ms(library, [prepare(*c) for c in copies], 200)
    del copies
    torch.cuda.empty_cache()
    # device time where the profiler sees the kernels, else the events' per-call time
    ms, plain_ms = dev_ms or call_ms, plain_dev_ms or plain_call_ms
    bound_ms, bound_by = bound(bytes_moved, ops, peak_ops)
    lib_text = "" if library is None else f"library {lib_dev_ms * 1e3:.2f} us on the device, {lib_call_ms * 1e3:.2f} us per call; "
    print(f"  kernel {dev_ms * 1e3:.2f} us on the device, {call_ms * 1e3:.2f} us per call (events); "
          f"plain {plain_dev_ms * 1e3:.2f} us on the device, {plain_call_ms * 1e3:.2f} us per call; {lib_text}"
          f"bound {bound_ms * 1e3:.2f} us ({bound_by}: {bytes_moved / 1e6:.2f} MB, {ops / 1e6:.1f} Mop)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, call_ms=call_ms,
                plain_call_ms=plain_call_ms, shape=label,
                library_ms=None if library is None else (lib_dev_ms or lib_call_ms))


def square_levels(side, strides=(8, 16, 32)):
    return tuple((side // s, side // s) for s in strides), strides


# (label, B, level sizes, strides, nc) at which phase 2 holds both decode kernels: plain predict at batch 1, 4
# and 8 at IMGSZ (8 is also the tiled path's 8 tiles), the TTA passes at 544 and 448 px, 6 tiles, nc = 80 on
# ragged levels, and a P6 pyramid of 4 levels
DECODE_SHAPES = (
    ("B1 640", 1, *square_levels(IMGSZ), 12),
    ("B4 640", 4, *square_levels(IMGSZ), 12),
    ("B8 640", 8, *square_levels(IMGSZ), 12),
    ("B4 544", 4, *square_levels(544), 12),
    ("B4 448", 4, *square_levels(448), 12),
    ("B6 640", 6, *square_levels(IMGSZ), 12),
    ("B2 ragged nc80", 2, ((37, 53), (19, 27), (10, 14)), (8, 16, 32), 80),
    ("B2 224 nc80", 2, *square_levels(224), 80),
    ("B2 640 P6", 2, *square_levels(IMGSZ, (8, 16, 32, 64)), 12),
)


def seeded_levels(g, dev, b, sizes, nc):
    """(B, 64 + nc, h, w) head levels, image 0's side 1 far below the others (NaN for a single row max)."""
    import torch

    from bsyolo_tpu_torch.kernels.decode import REG_MAX

    levels = [torch.randn((b, 4 * REG_MAX + nc, h, w), generator=g, device=dev) * 2.0 for h, w in sizes]
    for f in levels:
        f[0, REG_MAX : 2 * REG_MAX] -= 120.0
    return levels


def host_us(fn, inputs, reps: int = 20):
    """The calls' own host time, us per call: the loop's host clock before the card is
    waited for (the card runs behind the calls where they are host-bound)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        for args in inputs:
            fn(*args)
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed * 1e6 / (reps * len(inputs))


def host_us_in_turns(kernel, plain, inputs):
    """Host us per call of ``kernel`` and ``plain`` in turns (kernel, plain, kernel, plain)."""
    turns = [(label, host_us(fn, inputs)) for _ in range(2) for label, fn in (("kernel", kernel), ("plain", plain))]
    print("  host time per call, in turns: " + ", ".join(f"{label} {us:.2f} us" for label, us in turns))
    return min(us for label, us in turns if label == "kernel")


def check_decode_kernel(dev):
    """box_best_cuda against box_best_reference on the card at DECODE_SHAPES; returns the kernels-line fields."""
    import torch

    from bsyolo_tpu_torch.kernels.decode import REG_MAX, box_best_cuda, box_best_reference

    g = torch.Generator(device=dev).manual_seed(SEED)
    worst, rows = 0.0, {}
    for label, b, sizes, strides, nc in DECODE_SHAPES:
        levels = seeded_levels(g, dev, b, sizes, nc)
        a = sum(h * w for h, w in sizes)
        boxes, best, cls = box_best_cuda(levels, strides, nc)
        want_boxes, want_best, want_cls = box_best_reference(levels, strides, nc)
        torch.cuda.synchronize()
        err = (boxes - want_boxes).abs().max().item()
        best_err = (best - want_best).abs().max().item()
        cls_equal = torch.equal(cls, want_cls)
        finite = bool(torch.isfinite(boxes).all())
        ok = finite and err <= BOX_ATOL_PX and best_err == 0.0 and cls_equal
        print(f"decode_box_best {label}: B={b} A={a} nc={nc}: max|box err| {err:.3g} px (tol {BOX_ATOL_PX}), "
              f"max|best err| {best_err:.3g} (tol 0), class logits equal {cls_equal}, finite {finite}; "
              f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"decode_box_best disagrees with its plain version at {label}")
        worst = max(worst, err)
        head_bytes = b * a * (4 * REG_MAX + nc) * 4
        bytes_moved = head_bytes + b * a * (4 + 1 + nc) * 4  # head once; boxes, best and class logits once
        ops = b * a * (4 * (6 * REG_MAX + 1) + nc + 8)  # per side: max, sub, exp, add, fma (2); one divide
        old_bound_us = (head_bytes + 12 * a + b * a * 5 * 4) / PEAK_BYTES_PER_S * 1e6  # + anchors and strides
        print(f"  bound of the earlier flat-head kernel (anchors and strides read, no class-logit output): "
              f"{old_bound_us:.2f} us")
        rows[label] = time_against_plain(label, box_best_cuda, box_best_reference, (levels, strides, nc),
                                         bytes_moved, ops)
        rows[label]["host_us_per_call"] = host_us_in_turns(box_best_cuda, box_best_reference, [(levels, strides, nc)])
    # the kernels line reports the largest batch the predict phase runs
    return dict(max_abs_err=worst, **rows["B4 640"])


def check_decode_xywh_kernel(dev):
    """decode_xywh_cuda against decode_xywh_reference on the card at DECODE_SHAPES;
    returns the kernels-line fields."""
    import torch

    from bsyolo_tpu_torch.kernels.decode import REG_MAX, decode_xywh_cuda, decode_xywh_reference

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    worst, rows = 0.0, {}
    for label, b, sizes, strides, nc in DECODE_SHAPES:
        levels = seeded_levels(g, dev, b, sizes, nc)
        a = sum(h * w for h, w in sizes)
        got = decode_xywh_cuda(levels, strides, nc)
        want = decode_xywh_reference(levels, strides, nc)
        torch.cuda.synchronize()
        err = (got[..., :4] - want[..., :4]).abs().max().item()
        score_rel = ((got[..., 4:] - want[..., 4:]).abs() / want[..., 4:].abs()).max().item()
        finite = bool(torch.isfinite(got).all())
        ok = finite and tuple(got.shape) == (b, a, 4 + nc) and err <= BOX_ATOL_PX and score_rel <= SCORE_RTOL
        print(f"decode_xywh {label}: B={b} A={a} nc={nc}: max|box err| {err:.3g} px (tol {BOX_ATOL_PX}), "
              f"max score rel err {score_rel:.3g} (tol {SCORE_RTOL}), finite {finite}; {'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"decode_xywh disagrees with its plain version at {label}")
        worst = max(worst, err)
        head_bytes = b * a * (4 * REG_MAX + nc) * 4
        bytes_moved = head_bytes + b * a * (4 + nc) * 4  # head once, output rows once
        ops = b * a * (4 * (6 * REG_MAX + 1) + 10 + 4 * nc)  # the sides as above; box 10; sigmoid 4 per class
        old_bound_us = (head_bytes + 12 * a + b * a * (4 + nc) * 4) / PEAK_BYTES_PER_S * 1e6  # + anchors and strides
        print(f"  bound of the earlier flat-head kernel (anchors and strides read): {old_bound_us:.2f} us")
        rows[label] = time_against_plain(label, decode_xywh_cuda, decode_xywh_reference, (levels, strides, nc),
                                         bytes_moved, ops)
        rows[label]["host_us_per_call"] = host_us_in_turns(decode_xywh_cuda, decode_xywh_reference,
                                                           [(levels, strides, nc)])
    # the kernels line reports the TTA path's unscaled pass, B=4 at 640 px
    return dict(max_abs_err=worst, **rows["B4 640"])


# (label, B, level sizes, strides) of the 2-byte checks: the predict shape, and a P6 pyramid whose 5 x 5 level has
# odd H * W (its 2-byte rows start off 4-byte boundaries, so the kernel takes its plain loads there)
HALF_SHAPES = (("B4 640", 4, *square_levels(IMGSZ)), ("B2 P6 odd", 2, ((40, 40), (20, 20), (10, 10), (5, 5)),
                                                       (8, 16, 32, 64)))


def check_decode_2_byte_levels(dev):
    """Both decode kernels on bfloat16 and float16 levels against their plain versions (which cast to
    float32 first) on the same levels, timed at the predict shape; returns {kernel: {dtype: row}}."""
    import torch

    from bsyolo_tpu_torch.kernels.decode import (REG_MAX, box_best_cuda, box_best_reference, decode_xywh_cuda,
                                                 decode_xywh_reference)

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    nc, rows = 12, {"decode_box_best": {}, "decode_xywh": {}}
    for dtype in (torch.bfloat16, torch.float16):
        name = str(dtype).split(".")[1]
        for label, b, sizes, strides in HALF_SHAPES:
            levels = [f.to(dtype) for f in seeded_levels(g, dev, b, sizes, nc)]
            a = sum(h * w for h, w in sizes)
            boxes, best, cls = box_best_cuda(levels, strides, nc)
            wb, wbest, wcls = box_best_reference(levels, strides, nc)
            xywh, want = decode_xywh_cuda(levels, strides, nc), decode_xywh_reference(levels, strides, nc)
            torch.cuda.synchronize()
            box_err = max((boxes - wb).abs().max().item(), (xywh[..., :4] - want[..., :4]).abs().max().item())
            score_rel = ((xywh[..., 4:] - want[..., 4:]).abs() / want[..., 4:].abs()).max().item()
            ok = (box_err <= BOX_ATOL_PX and torch.equal(best, wbest) and torch.equal(cls, wcls)
                  and score_rel <= SCORE_RTOL and bool(torch.isfinite(boxes).all() and torch.isfinite(xywh).all())
                  and boxes.dtype == xywh.dtype == torch.float32)
            print(f"decode kernels on {name} levels, {label}: B={b} A={a} nc={nc}: max|box err| {box_err:.3g} px "
                  f"(tol {BOX_ATOL_PX}), best and class logits equal {torch.equal(best, wbest) and torch.equal(cls, wcls)},"
                  f" max score rel err {score_rel:.3g} (tol {SCORE_RTOL}); {'OK' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"a decode kernel disagrees with its plain version on {name} levels at {label}")
            if label != HALF_SHAPES[0][0]:
                continue
            head_bytes = b * a * (4 * REG_MAX + nc) * 2
            for kernel, plain, out_floats, ops in (
                    (box_best_cuda, box_best_reference, 5 + nc, 4 * (6 * REG_MAX + 1) + nc + 8),
                    (decode_xywh_cuda, decode_xywh_reference, 4 + nc, 4 * (6 * REG_MAX + 1) + 10 + 4 * nc)):
                key = "decode_box_best" if kernel is box_best_cuda else "decode_xywh"
                print(f"  {key} on {name} levels, {label}:")
                row = time_against_plain(f"{label} {name}", kernel, plain, (levels, strides, nc),
                                         head_bytes + b * a * out_floats * 4, b * a * ops)
                rows[key][name] = {k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "call_ms")}
                rows[key][name]["max_abs_err"] = box_err
    return rows


def head_outputs(graph, run):
    """The Detect head's level maps of every forward of ``graph`` (a DetectionGraph: a facade's
    ``model``, or its ``half_graph()``) that ``run()`` makes, as the path made them."""
    import torch

    captured = []
    hook = graph.model[-1].register_forward_hook(lambda mod, args, out: captured.append(out))
    try:
        run()
        torch.cuda.synchronize()
    finally:
        hook.remove()
    return captured


def check_decode_stage(label, decode, feats, kernel: str, reps: int = 50):
    """``decode(feats)``, the decode stage as the path calls it, on head maps the path made
    (in L2, as when the head has just written them): fails unless each call launches the
    ``kernel`` wrapper's kernel exactly once (its launch count) and the profiler sees no
    other device item; prints its device time (torch.profiler, per recorded launch) and
    host time per call. The launches are counted by the wrapper, not by the profiler: its
    sessions drop device events (43 to 49 of 50 recorded in phase 10, 6 of 50 in one run
    of phase 5's tiled stage on an NVIDIA H100 80GB HBM3 at 700 W)."""
    import torch
    from torch.autograd import DeviceType

    from bsyolo_tpu_torch import kernels

    def counter():
        return kernels.launch_counts()[kernel]

    repeat(decode, [(feats,)], 3)()
    torch.cuda.synchronize()
    calls, launches = repeat(decode, [(feats,)], reps), []

    def run():  # profiled() may run a session again: the launches of the session it returns are the last
        before = counter()
        calls()
        launches.append(counter() - before)

    events = [e for e in profiled(run).events() if e.device_type == DeviceType.CUDA]
    launched = launches[-1]
    others = sorted({e.name for e in events if "decode_kernel" not in e.name})
    device_us = sum(e.time_range.end - e.time_range.start for e in events) / max(len(events), 1)
    call_us = host_us(decode, [(feats,)])
    print(f"decode stage, {label}: {launched / reps:g} decode launches per call ({len(events)} recorded by the "
          f"profiler), {device_us:.2f} us of device time per launch, {call_us:.2f} us of host time per call; other "
          f"device items: {others or 'none'}")
    if launched != reps or others or not events:
        raise SystemExit(f"the {label} decode stage ran {launched} decode launches and {others} in {reps} calls "
                         f"(expected {reps}, all the decode kernel)")
    return device_us


def int8_operands(g, dev, m, k, n):
    """Seeded int8 codes x (m, k) and w (k, n), weight scales (n,) and an activation scale,
    laid out as the conv path lays them out: x in rows at a 16-byte pitch (its im2col),
    w the transpose of (n, k) rows at that pitch (its cached codes)."""
    import torch

    from bsyolo_tpu_torch.kernels.int8_matmul import empty_rows

    x = empty_rows(m, k, dev).copy_(torch.randint(-127, 128, (m, k), dtype=torch.int8, device=dev, generator=g))
    w = empty_rows(n, k, dev).copy_(torch.randint(-127, 128, (n, k), dtype=torch.int8, device=dev, generator=g)).t()
    sw = torch.rand(n, device=dev, generator=g) * 0.02 + 1e-3
    return x, w, sw, torch.tensor(0.013, device=dev)


def int8_library_inputs(x, w, sw, sx):
    """The operands as torch._int_mm takes them: K and N zero-padded to multiples of 8,
    the weight column-major (the transpose of an (N, K) tensor)."""
    import torch.nn.functional as F

    k, n = w.shape
    kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
    wt = F.pad(w.t(), (0, kp - k, 0, np_ - n)).contiguous()
    return F.pad(x, (0, kp - k)).contiguous(), wt.t(), F.pad(sw, (0, np_ - n)), sx


def int8_library(x, w, sw, sx):
    """The library yardstick: one int8 matrix product (cuBLASLt) and the dequantization."""
    import torch

    return torch._int_mm(x, w).float() * (sx * sw)


def int8_library_bf16(x, w, sw, sx):
    """The library yardstick of the bf16 epilogue: torch._int_mm and the dequantization to bfloat16."""
    import torch

    return (torch._int_mm(x, w).float() * (sx * sw)).to(torch.bfloat16)


def int8_bytes_ops(m, k, n, out_bytes: int = 4):
    """Bytes the product must move (each input once, the output once: float32, or bf16 with ``out_bytes``
    2) and its operations."""
    return m * k + k * n + 4 * n + 4 + out_bytes * m * n, 2 * m * n * k


def check_int8_kernel(dev):
    """int8_matmul_cuda against int8_matmul_reference on the card, exactly, float32 and
    bfloat16 out, at INT8_SHAPES; each timed against its plain version and torch._int_mm."""
    import torch

    from bsyolo_tpu_torch.kernels.int8_matmul import SMEM_LIMIT, Int8Weight
    from bsyolo_tpu_torch.kernels.int8_matmul import _launch as int8_launch  # takes a tile plan, to compare two
    from bsyolo_tpu_torch.kernels.int8_matmul import int8_matmul_cuda, int8_matmul_reference, smem_bytes, tile_plan

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst = 0.0
    for m, k, n in INT8_SHAPES:
        x, w, sw, sx = int8_operands(g, dev, m, k, n)
        print(f"int8_matmul M={m} K={k} N={n}, {tile_plan(m, n, k, 4, sms)}:")
        errs = []
        for dtype in (torch.float32, torch.bfloat16):
            got = int8_matmul_cuda(x, w, sw, sx, dtype)
            want = int8_matmul_reference(x, w, sw, sx, dtype)
            torch.cuda.synchronize()
            errs.append((got.float() - want.float()).abs().max().item())
        ok = errs == [0.0, 0.0]
        print(f"  max|err| {errs[0]:.3g} (float32 out), {errs[1]:.3g} (bfloat16 out), tol 0; {'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"int8_matmul disagrees with its plain version at M={m} K={k} N={n}")
        worst = max(worst, *errs)
        bytes_moved, ops = int8_bytes_ops(m, k, n)
        time_against_plain(f"M{m} K{k} N{n}", int8_matmul_cuda, int8_matmul_reference, (x, w, sw, sx), bytes_moved,
                           ops, PEAK_INT8_OPS_PER_S, int8_library, int8_library_inputs)
        plan = tile_plan(m, n, k, 4, sms)
        if plan.resident:  # the same product with the weight streamed through the stages, in turns with the plan's
            weight = Int8Weight(w, sw)
            streamed = plan._replace(resident=False, stages=min(4, plan.stages))
            while smem_bytes(streamed, k, 4) > SMEM_LIMIT:
                streamed = streamed._replace(stages=streamed.stages - 1)
            copies = [(torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device=dev).copy_(x),)
                      for _ in range(max(2, math.ceil(120e6 / (m * k))))]  # together beyond the 50 MB L2
            runs = [(label, p) for _ in range(2) for label, p in (("kept", plan), ("streamed", streamed))]
            us = [kernel_us(lambda xx, p=p: int8_launch(xx, weight, sx, torch.float32, p), copies, 40) for _, p in runs]
            del copies
            print("  weight kept in shared memory against streamed through the stages, in turns: " + ", ".join(
                f"{label} {t:.2f} us" for (label, _), t in zip(runs, us)) + f" (streamed {tuple(streamed)})")
    return worst


def draw_weights(model, seed: int) -> None:
    """Seeded random weights that keep the signal through the graph's depth:
    convs at U(+-sqrt(3 / fan_in)), BatchNorm statistics away from the
    identity, the head's last convs (a Classify head's linear layer) scaled by
    HEAD_GAIN (the default init leaves every logit at its bias, so every score
    ties)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            if p.dim() >= 2:
                bound = math.sqrt(3.0 / p[0].numel())
                p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=g))
            elif name.endswith(("running_var", "bn.weight")):
                p.copy_(torch.empty(p.shape).uniform_(0.5, 1.5, generator=g))
            else:
                p.copy_(torch.empty(p.shape).uniform_(-0.1, 0.1, generator=g))
        head = model.model[-1]
        if hasattr(head, "linear"):  # a Classify head: spread its logits as the Detect family's
            head.linear.weight.mul_(HEAD_GAIN)
            return
        for branch in (*head.cv2, *head.cv3):
            branch[-1].weight.mul_(HEAD_GAIN)


def match_pairs(got: np.ndarray, want: np.ndarray, box_px: float = MATCH_BOX_PX, score_tol: float = MATCH_SCORE):
    """Greedy match of each ``want`` row to the nearest unused ``got`` row of the
    same class, distance max(|box diff| / box_px, |score diff| / score_tol),
    accepted at distance <= 1; returns (got row, want row, box err, score err) of every matched pair."""
    used = np.zeros(len(got), bool)
    pairs = []
    for j, row in enumerate(want):
        cand = np.flatnonzero(~used & (got[:, 5] == row[5]))
        if not len(cand):
            continue
        box = np.abs(got[cand, :4] - row[:4]).max(1)
        score = np.abs(got[cand, 4] - row[4])
        dist = np.maximum(box / box_px, score / score_tol)
        k = int(np.argmin(dist))
        if dist[k] <= 1.0:
            used[cand[k]] = True
            pairs.append((int(cand[k]), j, float(box[k]), float(score[k])))
    return pairs


def make_models(dev):
    """The same seeded yolo11n on the CPU and, through YOLO()'s default device, on the card; the seeded frames."""
    from bsyolo_tpu_torch import YOLO

    host = YOLO("yolo11n.yaml", device="cpu", seed=SEED)
    draw_weights(host.model, SEED)
    model = YOLO("yolo11n.yaml", seed=SEED)
    model.model.load_state_dict(host.model.state_dict())
    if model.device != dev or next(model.model.parameters()).device != dev:
        raise SystemExit(f"YOLO() built its graph on {model.device}, not on {dev}")
    rng = np.random.default_rng(SEED)
    frames = [rng.integers(0, 256, (480, 640, 3) if i % 2 == 0 else (720, 1280, 3), dtype=np.uint8)
              for i in range(N_FRAMES)]
    print(f"yolo11n: {sum(p.numel() for p in model.model.parameters())} params, nc={len(model.names)}, "
          f"{N_FRAMES} frames 480x640 / 720x1280, imgsz {IMGSZ}, conf {CONF}")
    return host, model, frames


def expect_launches(path: str, expected: dict) -> dict:
    """Read the launch counters after a path's run; fail unless they are ``expected``."""
    from bsyolo_tpu_torch import kernels

    launches = kernels.launch_counts()
    print(f"kernel launches in the {path} runs: {launches} (expected {expected})")
    if launches != expected:
        raise SystemExit(f"the {path} path launched {launches}, expected {expected}")
    return launches


def profile_once(label: str, run, unprofiled_ms: float):
    """One call of ``run`` under torch.profiler: device work, busy share, largest device
    items; returns (name, device us, count) of every device item."""
    import torch

    walls = []

    def timed():
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)

    kern = sorted(device_kernels(profiled(timed)), key=lambda k: -k[1])
    wall_ms = walls[-1]
    busy_ms = sum(us for _, us, _ in kern) / 1e3
    print(f"{label} under torch.profiler: {wall_ms:.1f} ms wall, {busy_ms:.2f} ms of device work; device busy "
          f"{busy_ms / wall_ms:.3f} of the profiled wall time, {busy_ms / unprofiled_ms:.3f} of the unprofiled "
          f"{unprofiled_ms:.1f} ms; largest device items:")
    for name, us, n in kern[:10]:
        print(f"  {us / 1e3:8.3f} ms  {n:5d} x  {name[:100]}")
    return kern


def check_finite(label: str, dets) -> None:
    for i, d in enumerate(dets):
        if not (d.ndim == 2 and d.shape[1] == 6 and len(d) > 0 and np.isfinite(d).all()):
            raise SystemExit(f"{label}, frame {i}: detections are not finite (n, 6) rows: {d.shape}")


def compare_with_cpu(label: str, got, want, box_px: float = MATCH_BOX_PX, score_tol: float = MATCH_SCORE,
                     min_fraction: float = MATCH_MIN_FRACTION) -> float:
    """Card detections against the CPU's, frame by frame, paired by match_pairs; fails below
    ``min_fraction`` of the rows matched; returns the fraction."""
    n_want = n_got = same_frames = 0
    errs = []
    for g_, w in zip(got, want):
        e = [(b, s) for _, _, b, s in match_pairs(g_, w, box_px, score_tol)]
        n_want, n_got, errs = n_want + len(w), n_got + len(g_), errs + e
        same_frames += len(e) == len(w) == len(g_)
    frac = len(errs) / max(n_want, n_got)
    if not errs:
        errs = [(math.nan, math.nan)]
    box_q = np.quantile([e[0] for e in errs], [0.5, 0.99, 1.0])
    score_q = np.quantile([e[1] for e in errs], [0.5, 0.99, 1.0])
    print(f"detections card ({label}) vs CPU: {n_got} vs {n_want} rows, {len(errs)} matched ({frac:.4f}; "
          f"same class, |box| <= {box_px} px, |score| <= {score_tol}); {same_frames} of {len(got)} "
          f"frames match in every row; matched |box err| px p50/p99/max {box_q[0]:.3g}/{box_q[1]:.3g}/"
          f"{box_q[2]:.3g}, |score err| {score_q[0]:.3g}/{score_q[1]:.3g}/{score_q[2]:.3g}")
    if frac < min_fraction:
        raise SystemExit(f"card detections ({label}) match the CPU's in {frac:.4f} of rows, below {min_fraction}")
    return frac


def predict_path(dev, host, model, frames):
    """Phase 3: plain predict at batch 1 and 4; the box-best kernel once per batch."""
    import torch

    from bsyolo_tpu_torch import kernels
    from bsyolo_tpu_torch.kernels.decode import box_best, flatten_levels
    from bsyolo_tpu_torch.kernels.postprocess import detect_postprocess
    from bsyolo_tpu_torch.ops.letterbox import letterbox

    for batch in (1, 4):  # warm-up at both batch sizes: cuDNN plans, allocator, first-use kernel loads
        model.predict(frames[:4], imgsz=IMGSZ, batch=batch, conf=CONF)
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    runs, batch_ms = {}, {}
    for batch in (1, 4):
        t0 = time.perf_counter()
        res = model.predict(frames, imgsz=IMGSZ, batch=batch, conf=CONF)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_batches = math.ceil(N_FRAMES / batch)
        runs[batch] = [r.boxes.data for r in res]
        batch_ms[batch] = wall * 1e3 / n_batches
        print(f"predict batch {batch}: {N_FRAMES / wall:.1f} img/s, {wall * 1e3 / n_batches:.1f} ms per batch "
              f"(host clock, letterbox to Results), detections per frame {[len(r) for r in res]}")
        speed = {k: sum(r.speed[k] for r in res) / len(res) for k in res[0].speed}
        print("  Results.speed, ms per frame: " + ", ".join(f"{k} {v:.2f}" for k, v in speed.items()))
    batches = sum(math.ceil(N_FRAMES / b) for b in runs)
    launches = expect_launches("predict", {"decode_box_best": batches, "decode_xywh": 0, "int8_matmul": 0})

    profile_once("predict, one batch of 4", lambda: model.predict(frames[:4], imgsz=IMGSZ, batch=4, conf=CONF),
                 batch_ms[4])
    spec = model.spec
    for feats in head_outputs(model.model, lambda: model.predict(frames[:4], imgsz=IMGSZ, batch=4, conf=CONF)):
        check_decode_stage(f"predict, batch of 4 (box_best, as detect_postprocess calls it), levels "
                           f"{[tuple(f.shape[2:]) for f in feats]}",
                           lambda f: box_best(f, spec.head_strides, spec.nc, spec.reg_max), feats, "decode_box_best")

    # host-clock split of one batch of 4, synchronised after each stage; median of 5
    split = []
    for _ in range(5):
        t = [time.perf_counter()]
        x = torch.stack([letterbox(f, (IMGSZ, IMGSZ), dev) for f in frames[:4]])
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        with torch.inference_mode():
            feats = model.model(x.float() / 255.0)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            dets = detect_postprocess(feats, model.spec.head_strides, model.spec.nc, conf_thres=CONF)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
        dets.cpu()
        t.append(time.perf_counter())
        split.append(np.diff(t) * 1e3)
    med = np.median(split, 0)
    print("one batch of 4, stages synchronised, median of 5, ms: " + ", ".join(
        f"{k} {v:.2f}" for k, v in zip(("letterbox", "graph", "decode + NMS", "copy back"), med)))

    for batch, dets in runs.items():
        check_finite(f"predict batch {batch}", dets)
    # card vs CPU, same weights: head maps on one letterboxed batch, then detections
    x = torch.stack([letterbox(f, (IMGSZ, IMGSZ), "cpu") for f in frames[:4]])
    with torch.inference_mode():
        want = flatten_levels(host.model(x.float() / 255.0))
        got = flatten_levels(model.model(x.to(dev).float() / 255.0)).cpu()
    head_err = (got - want).abs().max().item()
    head_scale = want.abs().max().item()
    print(f"head maps card vs CPU (batch of 4): max|err| {head_err:.3g} at max|value| {head_scale:.3g}")
    if not head_err <= 1e-4 * head_scale:
        raise SystemExit("head maps on the card disagree with the CPU beyond rtol 1e-4 of their scale")
    cpu_res = [r.boxes.data for r in host.predict(frames, imgsz=IMGSZ, batch=4, conf=CONF)]
    for batch, dets in runs.items():
        compare_with_cpu(f"predict batch {batch}", dets, cpu_res)
    letterbox_in_turns(dev, model, frames)
    return launches


def interpolate_letterbox(frame, new_shape, device, pad_value: int = 114):
    """The predictor's letterbox as it was before it resized uint8 frames as OpenCV does: PyTorch's
    bilinear interpolation, rounded and clamped (within a grey level of OpenCV's); kept to time the two."""
    import torch
    import torch.nn.functional as F

    from bsyolo_tpu_torch.ops.letterbox import letterbox_params

    frame = torch.from_numpy(np.ascontiguousarray(frame)) if isinstance(frame, np.ndarray) else frame
    shape = tuple(frame.shape[:2])
    _, (dw, dh), new_unpad = letterbox_params(shape, new_shape)
    im = frame.to(device, non_blocking=True).permute(2, 0, 1)
    if shape[::-1] != new_unpad:
        x = F.interpolate(im[None].float(), size=(new_unpad[1], new_unpad[0]), mode="bilinear", align_corners=False)
        im = x[0].round_().clamp_(0, 255).to(torch.uint8)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    return F.pad(im, (left, right, top, bottom), value=pad_value).flip(0)


def letterbox_in_turns(dev, model, frames, turns: int = 4):
    """Phase 3's plain predict at batch 4 with the predictor's letterbox (OpenCV's integer INTER_LINEAR,
    ``ops/resize.py``) and with the earlier PyTorch bilinear one, in turns, on the host clock; and each
    letterbox alone over the 8 frames (synchronised)."""
    import torch

    from bsyolo_tpu_torch.engine import predictor as predictor_module
    from bsyolo_tpu_torch.ops.letterbox import letterbox

    fns = {"integer (OpenCV's)": letterbox, "interpolate (before)": interpolate_letterbox}
    for fn in fns.values():  # warm-up: the first call of each resize's kernels
        predictor_module.letterbox = fn
        model.predict(frames[:4], imgsz=IMGSZ, batch=4, conf=CONF)
    predictor_module.letterbox = letterbox
    times = {k: [] for k in fns}
    alone = {k: [] for k in fns}
    try:
        for t in range(turns):
            for name, fn in (fns.items() if t % 2 == 0 else reversed(fns.items())):
                predictor_module.letterbox = fn
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model.predict(frames, imgsz=IMGSZ, batch=4, conf=CONF)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3 / math.ceil(len(frames) / 4))
                t0 = time.perf_counter()
                for f in frames:
                    fn(f, (IMGSZ, IMGSZ), dev)
                torch.cuda.synchronize()
                alone[name].append((time.perf_counter() - t0) * 1e3 / len(frames))
    finally:
        predictor_module.letterbox = letterbox
    same = [torch.equal(letterbox(f, (IMGSZ, IMGSZ), dev).cpu(), letterbox(f, (IMGSZ, IMGSZ), "cpu")) for f in frames]
    for name in fns:
        print(f"predict batch 4 with the {name} letterbox, in turns: ms per batch {[round(v, 2) for v in times[name]]} "
              f"(host clock); the letterbox alone, ms per frame {[round(v, 3) for v in alone[name]]}")
    print(f"the letterbox on the card equals the CPU's, byte for byte, on {sum(same)} of {len(same)} frames")
    if not all(same):
        raise SystemExit("the predictor's letterbox on the card differs from the CPU's")
    return {k: float(np.median(v)) for k, v in times.items()}


def tta_path(host, model, frames):
    """Phase 4: predict(augment=True) at batch 4; the xywh kernel three times per batch, box-best never."""
    import torch

    from bsyolo_tpu_torch import kernels
    from bsyolo_tpu_torch.nn.heads import decode_detections

    model.predict(frames[:4], imgsz=IMGSZ, batch=4, conf=CONF, augment=True)  # warm-up: the 544 and 448 px plans
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = model.predict(frames, imgsz=IMGSZ, batch=4, conf=CONF, augment=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_batches = math.ceil(N_FRAMES / 4)
    batch_ms = wall * 1e3 / n_batches
    launches = expect_launches("TTA predict", {"decode_box_best": 0, "decode_xywh": 3 * n_batches, "int8_matmul": 0})
    print(f"TTA predict batch 4: {N_FRAMES / wall:.1f} img/s, {batch_ms:.1f} ms per batch "
          f"(host clock, letterbox to Results), detections per frame {[len(r) for r in res]}")
    speed = {k: sum(r.speed[k] for r in res) / len(res) for k in res[0].speed}
    print("  Results.speed, ms per frame: " + ", ".join(f"{k} {v:.2f}" for k, v in speed.items()))
    profile_once("TTA predict, one batch of 4",
                 lambda: model.predict(frames[:4], imgsz=IMGSZ, batch=4, conf=CONF, augment=True), batch_ms)
    spec = model.spec
    passes = head_outputs(model.model, lambda: model.predict(frames[:4], imgsz=IMGSZ, batch=4, conf=CONF,
                                                             augment=True))
    if len(passes) != 3:
        raise SystemExit(f"one TTA batch ran the head {len(passes)} times, expected 3")
    for i, feats in enumerate(passes):
        check_decode_stage(f"TTA pass {i + 1} of 3 (decode_detections), levels {[tuple(f.shape[2:]) for f in feats]}",
                           lambda f: decode_detections(f, spec.head_strides, spec.nc, spec.reg_max), feats,
                           "decode_xywh")

    got = [r.boxes.data for r in res]
    check_finite("TTA predict", got)
    want = [r.boxes.data for r in host.predict(frames[:4], imgsz=IMGSZ, batch=4, conf=CONF, augment=True)]
    compare_with_cpu("TTA predict, 4 frames", got[:4], want)
    return launches


def tiled_path(host, model):
    """Phase 5: predict_tiled with 640-px tiles on a 1080x1920 and a 720x1280 frame; the xywh kernel once per call."""
    import torch

    from bsyolo_tpu_torch import kernels
    from bsyolo_tpu_torch.engine.tiled import predict_tiled, tile_grid
    from bsyolo_tpu_torch.nn.heads import decode_detections

    rng = np.random.default_rng(SEED + 1)
    big = {f"{h}x{w}": rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in ((1080, 1920), (720, 1280))}
    reps = 5

    def run(m, frame):
        return predict_tiled(m.model, m.spec, frame, tile=IMGSZ, conf=CONF)

    for frame in big.values():  # warm-up: the batch-8 and batch-6 plans
        run(model, frame)
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    got, frame_ms = {}, {}
    for label, frame in big.items():
        times = []
        for _ in range(reps):
            before = kernels.launch_counts()["decode_xywh"]
            t0 = time.perf_counter()
            got[label] = run(model, frame)  # ends in a copy to the host, which waits for the card
            times.append((time.perf_counter() - t0) * 1e3)
            if kernels.launch_counts()["decode_xywh"] != before + 1:
                raise SystemExit(f"predict_tiled on the {label} frame did not launch decode_xywh exactly once")
        frame_ms[label] = float(np.median(times))
        print(f"tiled {label}: {len(tile_grid(*frame.shape[:2], IMGSZ))} tiles of {IMGSZ}, {frame_ms[label]:.1f} ms "
              f"per frame (host clock, frame to rows, median of {reps}; min {min(times):.1f}, max {max(times):.1f}), "
              f"{len(got[label])} detections")
    launches = expect_launches("tiled", {"decode_box_best": 0, "decode_xywh": reps * len(big), "int8_matmul": 0})
    profile_once("tiled, one 1080x1920 frame", lambda: run(model, big["1080x1920"]), frame_ms["1080x1920"])
    for feats in head_outputs(model.model, lambda: run(model, big["1080x1920"])):
        check_decode_stage(f"tiled 1080x1920 (decode_detections), B={feats[0].shape[0]}, levels "
                           f"{[tuple(f.shape[2:]) for f in feats]}",
                           lambda f: decode_detections(f, model.spec.head_strides, model.spec.nc, model.spec.reg_max),
                           feats, "decode_xywh")

    check_finite("tiled", list(got.values()))
    compare_with_cpu("tiled, 2 frames", list(got.values()), [run(host, f) for f in big.values()])
    return launches


def path_products(model, dev, imgsz: int = IMGSZ):
    """(M, K, N) of the int8 matmul of every quantizable conv in one forward of a batch of 4 at ``imgsz``."""
    import torch

    from bsyolo_tpu_torch.nn.modules import quantizable_convs

    shapes, hooks = [], []

    def record(m, args):
        b, c, h, w = args[0].shape
        (k, _), (s, _), (p, _) = m.conv.kernel_size, m.conv.stride, m.conv.padding
        oh, ow = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
        shapes.append((b * oh * ow, c * k * k, m.conv.out_channels))

    for _, m in quantizable_convs(model.model):
        hooks.append(m.register_forward_pre_hook(record))
    try:
        with torch.inference_mode():
            model.model(torch.zeros((4, 3, imgsz, imgsz), device=dev))
    finally:
        for h in hooks:
            h.remove()
    return shapes


def kernel_us(fn, inputs, reps: int):
    """Mean device us of the kernel events of ``reps`` calls of ``fn(*inputs[i % len(inputs)])``
    under torch.profiler (nan where no session saw a kernel)."""
    from torch.autograd import DeviceType

    events = [e for e in profiled(repeat(fn, inputs, reps)).events() if e.device_type == DeviceType.CUDA]
    return sum(e.time_range.end - e.time_range.start for e in events) / len(events) if events else math.nan


def product_times(fn, inputs, reps: int = 5):
    """Device us of ``fn`` per product, one profiler session each (a session can lose an
    event, so the launches of a whole forward cannot be matched to products by order)."""
    return [kernel_us(fn, [args], reps) for args in inputs]


def print_largest_products(us, shapes) -> None:
    """The five largest products beside their bound; the spread at each M."""
    print("  largest products (M, K, N): kernel us / bound us: " + "; ".join(
        f"{shapes[i]} {us[i]:.2f} / {bound(*int8_bytes_ops(*shapes[i]), PEAK_INT8_OPS_PER_S)[0] * 1e3:.2f}"
        for i in np.argsort(us)[::-1][:5]))
    by_m = {}
    for shape, t in zip(shapes, us):
        by_m.setdefault(shape[0], []).append(t)
    print("  kernel us per product by M (count, min / median / max, sum): " + "; ".join(
        f"M={m} ({len(t)}) {min(t):.2f} / {np.median(t):.2f} / {max(t):.2f}, {sum(t):.1f}"
        for m, t in sorted(by_m.items())))


def time_path_products(dev, shapes, label: str = f"yolo11n, batch 4, {IMGSZ} px", detail: bool = True):
    """The kernel, its plain version and torch._int_mm over every product of one forward,
    each product's operands drawn anew (their sum far exceeds the L2) and laid out as the
    conv path lays them out, the weight prepared once as the conv path caches it: device
    ms per forward from torch.profiler, the share of it outside the kernel (must be 0),
    host time per call; the kernel held exactly to the plain version at each product. ``detail``: also each
    product's time and the host time per call in turns."""
    import torch

    from bsyolo_tpu_torch.kernels.int8_matmul import (Int8Weight, int8_matmul_cuda, int8_matmul_prepared,
                                                      int8_matmul_reference, tile_plan)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    operands = [int8_operands(g, dev, *shape) for shape in shapes]
    prepared = [(x, Int8Weight(w, sw), sx) for x, w, sw, sx in operands]
    for (m, k, n), ops, args in zip(shapes, operands, prepared):
        for dtype in (torch.float32, torch.bfloat16):
            if not torch.equal(int8_matmul_prepared(*args, dtype), int8_matmul_reference(*ops, dtype)):
                raise SystemExit(f"int8_matmul disagrees with its plain version at the path shape M={m} K={k} N={n} "
                                 f"({dtype} out)")
    plans = {}
    for shape in shapes:
        plans.setdefault(tile_plan(shape[0], shape[2], shape[1], 4, sms), []).append(shape)
    print(f"int8_matmul tiles over the {len(shapes)} products (BM, BN, KB, stages, resident): " + "; ".join(
        f"{tuple(p)} x {len(v)}: {sorted(set(v))[:4]}{' ...' if len(set(v)) > 4 else ''}" for p, v in plans.items()))
    library_ops = [int8_library_inputs(*ops) for ops in operands]

    def per_forward(fn, inputs, reps):
        for args in inputs:  # warm-up
            fn(*args)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            for args in inputs:
                fn(*args)
        end.record()
        torch.cuda.synchronize()
        kern = device_kernels(profiled(repeat(fn, inputs, reps * len(inputs))))
        return start.elapsed_time(end) / reps, sum(us for _, us, _ in kern) / reps / 1e3, kern

    call_ms, ms, kern = per_forward(int8_matmul_prepared, prepared, 5)
    plain_call_ms, plain_ms, _ = per_forward(int8_matmul_reference, operands, 2)
    lib_call_ms, lib_ms, _ = per_forward(int8_library, library_ops, 5)
    # the bf16 epilogue (int8 on the half graph): the same products writing bfloat16
    bf16_call_ms, bf16_ms, bf16_kern = per_forward(lambda x, w, sx: int8_matmul_prepared(x, w, sx, torch.bfloat16),
                                                   prepared, 5)
    lib16_call_ms, lib16_ms, _ = per_forward(int8_library_bf16, library_ops, 5)
    bf16_bound_ms, bf16_bound_by = bound(sum(int8_bytes_ops(*s, out_bytes=2)[0] for s in shapes),
                                         sum(int8_bytes_ops(*s)[1] for s in shapes), PEAK_INT8_OPS_PER_S)
    bf16_names = sorted({name for name, _, _ in bf16_kern})
    print(f"int8_matmul through the bf16 epilogue over the same {len(shapes)} products: kernel {bf16_ms:.4f} ms on the "
          f"device per forward, {bf16_call_ms:.3f} ms host to host; torch._int_mm + dequantization to bf16 "
          f"{lib16_ms:.4f} ms on the device, {lib16_call_ms:.3f} ms host to host; bound {bf16_bound_ms:.4f} ms "
          f"({bf16_bound_by}, bf16 out); device items {[n[:60] for n in bf16_names]}")
    if any("int8_matmul_kernel" not in n or "bfloat16" not in n for n in bf16_names):
        raise SystemExit(f"the bf16 epilogue ran other device work or another instantiation: {bf16_names}")
    # host time per call in turns (prepared weight, as the conv path calls it; int8_matmul_cuda, which
    # prepares the weight on every call; torch._int_mm + dequantization), twice each
    turns = [(what, host_us(fn, inputs, 5)) for _ in range(2) for what, fn, inputs in (
        ("prepared", int8_matmul_prepared, prepared), ("int8_matmul_cuda", int8_matmul_cuda, operands),
        ("_int_mm", int8_library, library_ops))] if detail else []
    host = {what: min(us for name, us in turns if name == what) for what, _ in turns}
    kernel_only = sum(us for name, us, _ in kern if "int8_matmul_kernel" in name) / 5 / 1e3
    others = sorted({name for name, _, _ in kern if "int8_matmul_kernel" not in name})
    if detail:
        print_largest_products(product_times(int8_matmul_prepared, prepared), shapes)
    bytes_moved = sum(int8_bytes_ops(*shape)[0] for shape in shapes)
    n_ops = sum(int8_bytes_ops(*shape)[1] for shape in shapes)
    bound_ms, bound_by = bound(bytes_moved, n_ops, PEAK_INT8_OPS_PER_S)
    print(f"int8_matmul over the {len(shapes)} products of one forward ({label}; exact at each, float32 "
          f"and bfloat16 out): kernel {ms:.4f} ms on the device per forward, {call_ms:.3f} ms host to host (events); "
          f"plain {plain_ms:.4f} ms on the device, {plain_call_ms:.3f} ms host to host; torch._int_mm + "
          f"dequantization {lib_ms:.4f} ms on the device, {lib_call_ms:.3f} ms host to host; bound {bound_ms:.4f} ms "
          f"({bound_by}: {bytes_moved / 1e6:.1f} MB, {n_ops / 1e9:.2f} Gop)")
    if detail:
        print("  host time per call (the calls' own host time over 5 forwards, in turns): " + "; ".join(
            f"{what} {us:.2f} us" for what, us in turns) + " (prepared: the weight prepared once, as the conv path "
            "calls it; int8_matmul_cuda prepares it on every call; _int_mm: torch._int_mm + dequantization)")
    outside = (ms - kernel_only) / ms
    print(f"  device time outside int8_matmul_kernel: {outside:.4f} of {ms:.4f} ms (must be 0); other device "
          f"items: {others or 'none'}")
    if others:
        raise SystemExit(f"the int8 matmul wrapper ran device work besides its kernel: {others}")
    del operands, prepared, library_ops
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by, call_ms=call_ms,
                plain_call_ms=plain_call_ms, host_us_per_call=host.get("prepared"),
                shape=f"the {len(shapes)} products of one forward, {label}",
                bf16_out=dict(ms=bf16_ms, call_ms=bf16_call_ms, bound_ms=bf16_bound_ms, bound_by=bf16_bound_by,
                              library_ms=lib16_ms, library_call_ms=lib16_call_ms))


def check_int8_convs_against_cpu(dev, host, model, frames, imgsz: int = IMGSZ):
    """Every quantizable conv on the card, in int8 with the same scales, fed the input its
    CPU twin saw in a CPU int8 forward of ``frames``, gives the CPU twin's output within
    INT8_CONV_RTOL of its scale (a whole-graph comparison would show the code flips that
    float rounding sets off and later layers spread)."""
    import torch

    from bsyolo_tpu_torch.nn.modules import quantizable_convs
    from bsyolo_tpu_torch.ops.letterbox import letterbox

    seen, hooks = {}, []
    for name, m in quantizable_convs(host.model):
        hooks.append(m.register_forward_hook(lambda mod, args, out, name=name: seen.__setitem__(name, (args[0], out))))
    try:
        with torch.inference_mode():
            host.model(torch.stack([letterbox(f, (imgsz, imgsz), "cpu") for f in frames]).float() / 255.0)
    finally:
        for h in hooks:
            h.remove()
    worst, convs = 0.0, quantizable_convs(model.model)
    with torch.inference_mode():
        for name, m in convs:
            x, want = seen[name]
            got = m(x.to(dev)).cpu()
            err = ((got - want).abs().max() / want.abs().max()).item()
            if err > INT8_CONV_RTOL:
                raise SystemExit(f"int8 conv {name} on the card differs from the CPU by {err:.3g} of its scale")
            worst = max(worst, err)
    print(f"int8 convs card vs CPU, each fed the CPU's input: {len(convs)} convs, max|diff| / max|CPU| {worst:.3g} "
          f"(tol {INT8_CONV_RTOL})")


def int8_path(dev, host, model, frames):
    """Phase 6: calibration on the card, static int8 predict at batch 4 (the int8 matmul kernel
    once per quantizable conv per batch), int8 against float and against the CPU; one
    batch in dynamic int8, one in float; the kernel over the path's products."""
    import torch

    from bsyolo_tpu_torch import kernels
    from bsyolo_tpu_torch.kernels.decode import flatten_levels
    from bsyolo_tpu_torch.nn.modules import quantizable_convs, set_int8_inference
    from bsyolo_tpu_torch.nn.quant import calibrate_int8
    from bsyolo_tpu_torch.ops.letterbox import letterbox

    n_convs = len(quantizable_convs(model.model))
    if n_convs != 74:
        raise SystemExit(f"yolo11n has {n_convs} quantizable convs, expected 74")
    batches = [torch.stack([letterbox(f, (IMGSZ, IMGSZ), dev) for f in frames[i : i + 4]]).float() / 255.0
               for i in range(0, N_FRAMES, 4)]
    t0 = time.perf_counter()
    scales = calibrate_int8(model.model, batches)  # returns floats: the card has finished
    print(f"calibrate_int8 on the card over {N_FRAMES} letterboxed frames: {len(scales)} scales in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms; abs-max from {min(scales.values()):.3g} to "
          f"{max(scales.values()):.3g}")
    if len(scales) != n_convs:
        raise SystemExit(f"calibration returned {len(scales)} scales for {n_convs} quantizable convs")
    set_int8_inference(model.model, True, scales)
    model.predict(frames[:4], imgsz=IMGSZ, batch=4, conf=CONF)  # warm-up: weight codes, first launches
    torch.cuda.synchronize()

    n_batches = math.ceil(N_FRAMES / 4)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = model.predict(frames, imgsz=IMGSZ, batch=4, conf=CONF)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = expect_launches("int8 predict",
                               {"decode_box_best": n_batches, "decode_xywh": 0, "int8_matmul": n_convs * n_batches})
    batch_ms = wall * 1e3 / n_batches
    print(f"int8 predict batch 4 (static scales): {N_FRAMES / wall:.1f} img/s, {batch_ms:.1f} ms per batch "
          f"(host clock, letterbox to Results), detections per frame {[len(r) for r in res]}")
    speed = {k: sum(r.speed[k] for r in res) / len(res) for k in res[0].speed}
    print("  Results.speed, ms per frame: " + ", ".join(f"{k} {v:.2f}" for k, v in speed.items()))
    kern = profile_once("int8 predict, one batch of 4",
                        lambda: model.predict(frames[:4], imgsz=IMGSZ, batch=4, conf=CONF), batch_ms)
    int8_us = sum(us for name, us, _ in kern if "int8_matmul_kernel" in name)
    print(f"  int8_matmul kernels in that batch: {int8_us / 1e3:.3f} ms of device time over "
          f"{sum(n for name, _, n in kern if 'int8_matmul_kernel' in name)} launches")

    got = [r.boxes.data for r in res]
    check_finite("int8 predict", got)

    # float and int8 predict in turns (float, int8, int8, float), host clock, 8 frames at batch 4 each
    turns = []
    for int8 in (False, True, True, False):
        set_int8_inference(model.model, int8, scales)
        model.predict(frames[:4], imgsz=IMGSZ, batch=4, conf=CONF)  # warm-up after the switch: weight codes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.predict(frames, imgsz=IMGSZ, batch=4, conf=CONF)
        torch.cuda.synchronize()
        turns.append((time.perf_counter() - t0) * 1e3 / n_batches)
    print(f"float and int8 predict in turns, ms per batch of 4 (host clock): float {turns[0]:.1f}, int8 {turns[1]:.1f}, "
          f"int8 {turns[2]:.1f}, float {turns[3]:.1f}")

    with torch.inference_mode():
        set_int8_inference(model.model, True, scales)
        heads8 = flatten_levels(model.model(batches[0]))
        set_int8_inference(model.model, False)
        heads = flatten_levels(model.model(batches[0]))
    rel = ((heads8 - heads).abs().max() / heads.abs().max()).item()
    print(f"head maps int8 vs float on the card (batch of 4): max|diff| / max|float| {rel:.3g} (bounds 1e-6, 0.1)")
    if not 1e-6 < rel < 0.1:
        raise SystemExit(f"int8 head maps differ from float by {rel:.3g} of their scale, outside (1e-6, 0.1)")

    set_int8_inference(model.model, True, scales)
    set_int8_inference(host.model, True, scales)
    try:
        check_int8_convs_against_cpu(dev, host, model, frames[:4])
        want = [r.boxes.data for r in host.predict(frames, imgsz=IMGSZ, batch=4, conf=CONF)]
    finally:
        set_int8_inference(host.model, False)
    compare_with_cpu("int8 predict, at the float tolerances", got, want, min_fraction=0.0)
    compare_with_cpu("int8 predict", got, want, INT8_MATCH_BOX_PX, INT8_MATCH_SCORE, INT8_MATCH_MIN_FRACTION)

    set_int8_inference(model.model, True)  # dynamic: each conv's scale from its batch
    kernels.reset_launch_counts()
    dyn = model.predict(frames[:4], imgsz=IMGSZ, batch=4, conf=CONF)
    expect_launches("dynamic int8 predict, one batch", {"decode_box_best": 1, "decode_xywh": 0, "int8_matmul": n_convs})
    check_finite("dynamic int8 predict", [r.boxes.data for r in dyn])
    set_int8_inference(model.model, False)
    kernels.reset_launch_counts()
    model.predict(frames[:4], imgsz=IMGSZ, batch=4, conf=CONF)
    expect_launches("float predict after int8, one batch", {"decode_box_best": 1, "decode_xywh": 0, "int8_matmul": 0})

    row = time_path_products(dev, path_products(model, dev))
    return launches, row


# phases 7 and 8: the train step and the validator
TRAIN_BATCH, TRAIN_STEPS, TRAIN_CPU_BATCH = 16, 30, 4
TRAIN_NB = 10  # batches per epoch of the schedule: warmup max(round(3 * 10), 100) = 100 iterations
TRAIN_NBS = 64  # nbs / batch = 4 at batch 16: the accumulation count is 2 from iteration 17 on
M_GT = 8  # label rows per image
# card vs CPU after one train step at batch 4. The step is the same Python on both devices; only the
# libraries' kernels differ: cuDNN's float32 convolutions and BatchNorm, forward and backward, against
# the CPU's, each summing in its own order. With draw_weights' head the class logits are saturated (a loss
# near 1e5) and many gradients are small sums of large terms that cancel: a BatchNorm weight's gradient
# sums dy * x_hat over up to 102,400 pixels per channel. Measured on an NVIDIA H100 80GB HBM3 at 700 W:
# gradients per tensor (norm of the difference over the CPU's norm) median 1.5e-4, p99 9.1e-3, max
# 3.3e-2; the whole gradient 4.9e-3 of its norm; params after the step (max |diff| over the tensor's max
# |value|) up to 9.8e-4, through the biases' lr of 0.1; BatchNorm statistics 1.1e-6; loss items 1.6e-5.
# The same card run twice differs by 1.6e-6 (whole gradient); a run with cuDNN's deterministic
# algorithms is printed beside it, to show how far the card's own float32 algorithms spread. A tensor
# whose gradient norm is below GRAD_FLOOR of the whole gradient's is held to its difference over the
# whole gradient's norm: some gradients are analytically 0 (a BatchNorm bias before another BatchNorm)
# and hold float32 noise on either side.
# A float64 copy of the graph on the CPU is the referee (the loss itself in float32, as in the JAX package).
# Measured on the same card: the card's float32 gradient 1.2e-4 of the norm from the float64 one (per tensor
# at most 6.4e-4), the CPU's 4.9e-3 (per tensor up to 3.4e-2), so the card-vs-CPU gap is the CPU's float32
# backward. The card is held to TRAIN_GRAD_F64_RTOL of the float64 gradient.
TRAIN_LOSS_RTOL, TRAIN_BN_RTOL = 1e-4, 1e-4
TRAIN_GRAD_RTOL, TRAIN_TENSOR_GRAD_RTOL, TRAIN_PARAM_RTOL = 1e-2, 5e-2, 2e-3
TRAIN_GRAD_F64_RTOL = 2e-3
GRAD_FLOOR, FLOOR_TOL = 1e-6, 1e-8
VAL_BATCH, VAL_SHAPES = 8, ((640, 640), (640, 640), (384, 640), (384, 640))
VAL_PAD_ROWS = 3  # rows that pad the last val batch (im_idx -1)
VAL_METRIC_ATOL = 0.01  # card vs CPU mAP50, mAP50-95, P, R: the rows differ only where scores nearly tie


def synthetic_batch(rng, b: int, hw, nc: int = 12):
    """A batch in the padded-label contract: uint8 (b, 3, H, W) frames of dark noise with 1 to 4
    filled rectangles each, one colour per class; cls (b, M_GT), normalized xywh bboxes, mask."""
    h, w = hw
    colours = (np.arange(nc)[:, None] * np.array([97, 57, 23]) + np.array([40, 90, 150])) % 200 + 55
    img = rng.integers(0, 60, (b, 3, h, w), dtype=np.uint8)
    cls = np.zeros((b, M_GT), np.int64)
    boxes = np.zeros((b, M_GT, 4), np.float32)
    mask = np.zeros((b, M_GT), np.float32)
    for i in range(b):
        for j in range(int(rng.integers(1, 5))):
            bw, bh = int(rng.integers(w // 16, w // 3)), int(rng.integers(h // 16, h // 3))
            x0, y0 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            c = int(rng.integers(0, nc))
            img[i, :, y0 : y0 + bh, x0 : x0 + bw] = colours[c][:, None, None]
            boxes[i, j] = [(x0 + bw / 2) / w, (y0 + bh / 2) / h, bw / w, bh / h]
            cls[i, j], mask[i, j] = c, 1.0
    return {"img": img, "cls": cls, "bboxes": boxes, "mask": mask}


def on_device(batch, dev):
    import torch

    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def train_config(spec, batch: int):
    """The smoke's step configuration: SGD, lr0 0.01, nbs 64, default momentum and warmup."""
    from bsyolo_tpu_torch.engine.optim import OptimConfig, scaled_weight_decay
    from bsyolo_tpu_torch.engine.train_step import StepConfig
    from bsyolo_tpu_torch.losses import DetectionLossConfig

    optim = OptimConfig(name="SGD", lr0=0.01, nbs=TRAIN_NBS)
    accumulate = max(round(TRAIN_NBS / batch), 1)
    return StepConfig(loss=DetectionLossConfig(nc=spec.nc, strides=spec.head_strides), optim=optim, batch_size=batch,
                      nb=TRAIN_NB, nw=max(round(optim.warmup_epochs * TRAIN_NB), 100), use_adamw=False,
                      weight_decay=scaled_weight_decay(optim, batch, accumulate))


def loss_gradients(graph, spec, b, dev):
    """(loss items, name -> gradient on the CPU) of the detection loss at the graph's weights, in
    train mode; the image is cast to the graph's dtype (a float64 graph's loss still runs in float32)."""
    from bsyolo_tpu_torch.losses import detection_loss, init_loss_state
    from bsyolo_tpu_torch.ops.normalize import normalize_image_batch

    graph.train()
    x = normalize_image_batch(b["img"]).to(next(graph.parameters()).dtype)
    total, items, _ = detection_loss(graph(x), b["cls"], b["bboxes"], b["mask"], init_loss_state(dev),
                                     train_config(spec, TRAIN_CPU_BATCH).loss)
    total.backward()
    grads = {n: p.grad.detach().cpu() for n, p in graph.named_parameters()}
    graph.zero_grad(set_to_none=True)
    return items.detach().cpu(), grads


def one_train_step(graph, spec, batch, dev):
    """The gradients of the loss at the graph's weights, then one train step from the same weights
    (the BatchNorm statistics restored in between); returns what phase 7a compares, on the CPU."""
    from bsyolo_tpu_torch.engine.train_step import init_train_state, make_train_step

    cfg = train_config(spec, TRAIN_CPU_BATCH)
    b = on_device(batch, dev)
    snapshot = {k: v.clone() for k, v in graph.state_dict().items()}
    items, grads = loss_gradients(graph, spec, b, dev)
    graph.load_state_dict(snapshot)
    state, metrics = make_train_step(graph, cfg)(init_train_state(graph, cfg), b)
    cpu = lambda d: {k: v.detach().cpu().clone() for k, v in d.items()}
    graph.eval()
    return {"items": items, "grads": grads, "params": cpu(state.params), "ema": cpu(state.ema_params),
            "bn": cpu(state.batch_stats), "momentum": cpu(state.slot0), "loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]), "updated": metrics["updated"]}


def against_float64(label, grads, ref):
    """The whole gradient's distance from the float64 graph's, over its norm; printed per tensor too."""
    total = _whole_norm(ref.values())
    whole = _whole_norm(grads[n].double() - g for n, g in ref.items()) / total
    big = {n: _rel_norm(grads[n].double(), g) for n, g in ref.items() if g.norm().item() >= GRAD_FLOOR * total}
    q = np.quantile(list(big.values()), [0.5, 0.99, 1.0])
    print(f"  {label} vs the float64 graph's gradient: whole {whole:.3g} of its norm; per tensor median {q[0]:.3g}, "
          f"p99 {q[1]:.3g}, max {q[2]:.3g} ({len(big)} tensors above {GRAD_FLOOR} of the whole norm)")
    return whole


def _rel_max(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def _rel_norm(got, want):
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def _whole_norm(tensors):
    return math.sqrt(sum(t.double().norm().item() ** 2 for t in tensors))


def compare_step(label, got, want, check=True):
    """One train step's results against another's (see TRAIN_*); returns the names of what failed."""
    failures = []
    items_err = ((got["items"] - want["items"]).abs() / want["items"].abs().clamp_min(1e-30)).max().item()
    print(f"  {label}: loss items (box, cls, dfl) {got['items'].tolist()} vs {want['items'].tolist()}: max rel err "
          f"{items_err:.3g} (tol {TRAIN_LOSS_RTOL})")
    if items_err > TRAIN_LOSS_RTOL or got["updated"] != want["updated"]:
        failures.append("loss items")
    for what, key, err_fn, tol in (("gradients", "grads", _rel_norm, TRAIN_TENSOR_GRAD_RTOL),
                                   ("momentum buffers", "momentum", _rel_norm, TRAIN_TENSOR_GRAD_RTOL),
                                   ("params", "params", _rel_max, TRAIN_PARAM_RTOL),
                                   ("EMA params", "ema", _rel_max, TRAIN_PARAM_RTOL),
                                   ("BatchNorm statistics", "bn", _rel_max, TRAIN_BN_RTOL)):
        total = _whole_norm(want[key].values())
        whole = _whole_norm(got[key][n] - w for n, w in want[key].items()) / total
        errs, small = {}, {}
        for name, w in want[key].items():
            if key in ("grads", "momentum") and w.norm().item() < GRAD_FLOOR * total:
                small[name] = (got[key][name] - w).norm().item() / total
            else:
                errs[name] = err_fn(got[key][name], w)
        worst = max(errs, key=errs.get)
        q = np.quantile(list(errs.values()), [0.5, 0.99])
        text = (f"  {label}: {what}: whole {whole:.3g} of its norm; {len(errs)} tensors, rel err median {q[0]:.3g}, "
                f"p99 {q[1]:.3g}, max {errs[worst]:.3g} ({worst}) (tol {tol})")
        if small:
            text += (f"; {len(small)} below {GRAD_FLOOR} of the whole norm: max |diff| / whole norm "
                     f"{max(small.values()):.3g} (tol {FLOOR_TOL})")
        if key in ("grads", "momentum"):
            text += f"; whole tol {TRAIN_GRAD_RTOL}"
        print(text)
        if (errs[worst] > tol or any(e > FLOOR_TOL for e in small.values())
                or key in ("grads", "momentum") and whole > TRAIN_GRAD_RTOL):
            failures.append(what)
    return failures


def train_step_against_cpu(dev, host, model):
    """Phase 7a: one step at batch 4, card against CPU; beside it, a second card run and one
    with cuDNN's deterministic algorithms. Returns the batch and the float64 graph's gradient."""
    import torch

    batch = synthetic_batch(np.random.default_rng(SEED + 10), TRAIN_CPU_BATCH, (IMGSZ, IMGSZ), len(model.names))
    t0 = time.perf_counter()
    reference = copy.deepcopy(host.model).double()  # the graph in float64, from the same weights
    _, ref_grads = loss_gradients(reference, host.spec, on_device(batch, "cpu"), "cpu")
    del reference
    ref_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = one_train_step(host.model, host.spec, batch, "cpu")
    cpu_s = time.perf_counter() - t0
    start = {k: v.clone() for k, v in model.model.state_dict().items()}
    got = one_train_step(model.model, model.spec, batch, dev)
    model.model.load_state_dict(start)
    again = one_train_step(model.model, model.spec, batch, dev)
    model.model.load_state_dict(start)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        deterministic = one_train_step(model.model, model.spec, batch, dev)
    finally:
        torch.backends.cudnn.deterministic = False
    print(f"train step, batch {TRAIN_CPU_BATCH} at {IMGSZ}, card vs CPU (CPU: {cpu_s:.1f} s for the gradients and "
          f"the step): loss {got['loss']:.6g} vs {want['loss']:.6g}, grad norm {got['grad_norm']:.6g} vs "
          f"{want['grad_norm']:.6g}, updated {got['updated']} vs {want['updated']}")
    failures = compare_step("card vs CPU", got, want)
    compare_step("card vs card, run to run", again, got)
    compare_step("card, cuDNN's deterministic algorithms vs its default ones", deterministic, got)
    print(f"  the float64 graph's gradient on the CPU ({ref_s:.1f} s; the loss in float32, as in the JAX package):")
    if against_float64("card", got["grads"], ref_grads) > TRAIN_GRAD_F64_RTOL:
        failures.append(f"gradients against the float64 graph's (tol {TRAIN_GRAD_F64_RTOL})")
    against_float64("CPU", want["grads"], ref_grads)
    if failures or want["updated"] != 1:
        raise SystemExit(f"train step on the card differs from the CPU in: {failures}")
    return batch, ref_grads


def expected_updates(n_steps: int, nw: int, nbs_over_batch: float):
    """The host's rule: the accumulation count ramps from 1 to round(nbs / batch) over the warmup
    (rounded half to even), and a step updates when that many iterations passed since the last update."""
    last, flags = -1, []
    for ni in range(n_steps):
        acc = max(round(1 + min(ni / nw, 1.0) * (round(nbs_over_batch) - 1)), 1)
        flags.append(int(ni - last >= acc))
        last = ni if flags[-1] else last
    return flags


def train_path(dev, model, label: str = "train"):
    """Phase 7b (and 10d on the bf16 graph): TRAIN_STEPS steps at batch 16 on the card on a repeated
    batch; returns the state and the run's figures."""
    import torch

    from bsyolo_tpu_torch import kernels
    from bsyolo_tpu_torch.engine.train_step import init_train_state, make_train_step

    cfg = train_config(model.spec, TRAIN_BATCH)
    batch = on_device(synthetic_batch(np.random.default_rng(SEED + 11), TRAIN_BATCH, (IMGSZ, IMGSZ),
                                      len(model.names)), dev)
    state = init_train_state(model.model, cfg)
    step = make_train_step(model.model, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    metrics, timed_ms = [], 0.0
    timed = range(10, 20)  # 0 to 9 warm up; 20 to 29 run under the profiler
    walls = []

    def run(steps):
        nonlocal state
        for _ in steps:
            state, m = step(state, batch)
            metrics.append(m)

    run(range(10))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(timed)
    torch.cuda.synchronize()
    timed_ms = (time.perf_counter() - t0) * 1e3 / len(timed)

    def profiled_steps():
        t1 = time.perf_counter()
        run(range(20, TRAIN_STEPS))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)

    kern = device_kernels(profiled(profiled_steps))  # a session the profiler runs again adds steps: all are checked
    busy_ms = sum(us for _, us, _ in kern) / 1e3
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    expect_launches(label, {name: 0 for name in kernels.KERNELS})

    losses = torch.stack([m["loss"] for m in metrics]).cpu().numpy()  # the one readback of the run
    updated = [m["updated"] for m in metrics]
    want = expected_updates(len(metrics), cfg.nw, cfg.optim.nbs / cfg.batch_size)
    n_prof = TRAIN_STEPS - 20
    first, last = losses[:5].mean(), losses[-5:].mean()
    print(f"{label} {TRAIN_STEPS} steps, batch {TRAIN_BATCH} at {IMGSZ} (SGD lr0 {cfg.optim.lr0}, nbs {cfg.optim.nbs}, "
          f"warmup {cfg.nw} iterations): updated {''.join(map(str, updated))} (host's rule "
          f"{''.join(map(str, want))}); loss first 5 mean {first:.4g}, last 5 mean {last:.4g}; "
          f"losses {np.array2string(losses, precision=4, max_line_width=400)}")
    print(f"  {timed_ms:.2f} ms per step, {TRAIN_BATCH * 1e3 / timed_ms:.1f} img/s over steps {timed.start} to "
          f"{timed.stop - 1} (host clock, synchronized); {n_prof} more steps under torch.profiler: "
          f"{walls[-1] / n_prof:.2f} ms per step wall, {busy_ms / n_prof:.2f} ms of device work per step, device "
          f"busy {busy_ms / walls[-1]:.3f}; peak memory allocated {peak_gb:.2f} GB")
    for name, us, n in sorted(kern, key=lambda k: -k[1])[:8]:
        print(f"  {us / 1e3 / n_prof:8.3f} ms per step  {n // n_prof:5d} x  {name[:100]}")
    if updated != want:
        raise SystemExit(f"train steps updated {updated}, the host's rule says {want}")
    if not np.isfinite(losses).all() or not last < first:
        raise SystemExit(f"train losses not finite or not falling: first 5 mean {first}, last 5 mean {last}")
    if want[:2] != [1, 1] or 0 not in want:
        raise SystemExit("the configuration does not take the accumulation count from 1 to 2 within the run")
    return state, {"ms": timed_ms, "device_ms": busy_ms / n_prof, "busy": busy_ms / walls[-1], "peak_gb": peak_gb,
                   "kernels": {name: us / n_prof for name, us, _ in kern}}


def val_batches():
    rng = np.random.default_rng(SEED + 12)
    batches = []
    for i, hw in enumerate(VAL_SHAPES):
        b = synthetic_batch(rng, VAL_BATCH, hw)
        b["im_idx"] = np.arange(i * VAL_BATCH, (i + 1) * VAL_BATCH)
        batches.append(b)
    batches[-1]["im_idx"][-VAL_PAD_ROWS:] = -1
    for k in ("img", "cls", "bboxes", "mask"):  # the padding rows repeat the batch's first rows
        batches[-1][k][-VAL_PAD_ROWS:] = batches[-1][k][:VAL_PAD_ROWS]
    return batches


@contextlib.contextmanager
def plain_decode_calls():
    """A list that gets one entry per call of either decode's plain version while the block runs."""
    from bsyolo_tpu_torch.kernels import decode

    calls, box, xywh = [], decode.box_best_reference, decode.decode_xywh_reference
    decode.box_best_reference = lambda *a, **k: calls.append("box") or box(*a, **k)
    decode.decode_xywh_reference = lambda *a, **k: calls.append("xywh") or xywh(*a, **k)
    try:
        yield calls
    finally:
        decode.box_best_reference, decode.decode_xywh_reference = box, xywh


def val_path(dev, host, model, state):
    """Phase 8: the validator on the card over the EMA parameters of phase 7b, against the CPU."""
    import torch

    from bsyolo_tpu_torch import kernels
    from bsyolo_tpu_torch.engine.validator import DetectionValidator

    batches = val_batches()
    n_img = sum(int((b["im_idx"] >= 0).sum()) for b in batches)
    ema = state.ema_params
    card = DetectionValidator(model.model, model.spec, names=model.names)  # cuda:0 by default
    if card.device != dev:
        raise SystemExit(f"DetectionValidator runs on {card.device}, not on {dev}")
    card(ema, batches[1:3])  # warm-up at both canvas shapes
    torch.cuda.synchronize()

    with plain_decode_calls() as plain_calls:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        got = card(ema, batches)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = expect_launches("validation", {"decode_box_best": len(batches), "decode_xywh": 0, "int8_matmul": 0})
    if plain_calls:
        raise SystemExit(f"the validator ran the decode's plain version {len(plain_calls)} times on the card")
    print(f"validation on the card: {len(batches)} batches of {VAL_BATCH} at {sorted(set(VAL_SHAPES))}, {n_img} "
          f"images (+{VAL_PAD_ROWS} padding rows): {wall * 1e3 / n_img:.2f} ms per image (host clock, batches to "
          f"metrics), speed['inference'] {got.speed['inference']:.2f} ms per image")

    host.model.load_state_dict({k: v.cpu() for k, v in model.model.state_dict().items()})  # live BN statistics
    ema_cpu = {k: v.cpu() for k, v in ema.items()}
    cpu = DetectionValidator(host.model, host.spec, names=host.names, device="cpu")
    want = cpu(ema_cpu, batches)
    g, w = got.results_dict, want.results_dict
    print("  metrics card vs CPU: " + ", ".join(f"{k} {g[k]:.5f} vs {w[k]:.5f}" for k in w)
          + f" (tol {VAL_METRIC_ATOL} absolute)")
    if any(abs(g[k] - w[k]) > VAL_METRIC_ATOL for k in w):
        raise SystemExit("validation metrics on the card differ from the CPU's")
    got_rows, want_rows = [], []
    for b in batches:
        keep = b["im_idx"] >= 0
        gd = card._forward(ema, b["img"]).cpu().numpy()[keep]
        wd = cpu._forward(ema_cpu, b["img"]).numpy()[keep]
        got_rows += [d[d[:, 4] > 0] for d in gd]
        want_rows += [d[d[:, 4] > 0] for d in wd]
    check_finite("validation detections", got_rows)
    compare_with_cpu("validation", got_rows, want_rows)
    return launches


# phase 9: the trainer and the facade
P9_TRAIN, P9_VAL, P9_HW = 64, 16, (480, 640)
P9_BATCH, P9_WORKERS = 16, 4


def write_png_dataset(root, names, seed: int):
    """P9_TRAIN + P9_VAL seeded 480x640 PNG frames in the images/ and labels/ layout, 1 to 4 filled
    rectangles each, one colour per class; returns the dataset YAML's path."""
    from bsyolo_tpu_torch.data.imread import imwrite_png

    rng = np.random.default_rng(seed)
    colours = rng.integers(40, 256, (len(names), 3))
    h, w = P9_HW
    for split, n in (("train", P9_TRAIN), ("val", P9_VAL)):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
        for i in range(n):
            img = rng.integers(0, 40, (h, w, 3), dtype=np.uint8)
            rows = []
            for _ in range(int(rng.integers(1, 5))):
                bw, bh = int(rng.integers(w // 12, w // 3)), int(rng.integers(h // 12, h // 3))
                x0, y0, c = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh)), int(rng.integers(0, len(names)))
                img[y0 : y0 + bh, x0 : x0 + bw] = colours[c]
                rows.append(f"{c} {(x0 + bw / 2) / w:.6f} {(y0 + bh / 2) / h:.6f} {bw / w:.6f} {bh / h:.6f}")
            imwrite_png(root / "images" / split / f"{i:04d}.png", img)
            (root / "labels" / split / f"{i:04d}.txt").write_text("\n".join(rows) + "\n")
    yaml = root / "data.yaml"
    yaml.write_text(f"path: {root}\ntrain: images/train\nval: images/val\nnames:\n"
                    + "".join(f"  {i}: {n}\n" for i, n in enumerate(names)))
    return yaml


def trainer_path(dev, frames, root):
    """Phase 9: YOLO.train (2 epochs, then a resume to 3), YOLO(best.ckpt).val and .predict on the card,
    on a dataset written under ``root``; returns the launches and the dataset YAML."""
    import csv
    from pathlib import Path

    import torch

    from bsyolo_tpu_torch import YOLO, kernels
    from bsyolo_tpu_torch.cfg import CFG_ROOT, read_yaml
    from bsyolo_tpu_torch.data import DataLoader, YOLODataset
    from bsyolo_tpu_torch.utils.ckpt import load_checkpoint
    from bsyolo_tpu_torch.utils.weights import state_dict_from_jax

    names = [str(read_yaml(CFG_ROOT / "datasets" / "car.yaml")["names"][i]) for i in range(12)]
    t0 = time.perf_counter()
    data = write_png_dataset(Path(root) / "ds", names, SEED + 20)
    print(f"phase 9 dataset: {P9_TRAIN} train + {P9_VAL} val PNG frames {P9_HW[0]}x{P9_HW[1]}, {len(names)} "
          f"car.yaml classes, written in {time.perf_counter() - t0:.2f} s")
    run = dict(data=str(data), imgsz=IMGSZ, batch=P9_BATCH, amp=False, plots=False, workers=P9_WORKERS, seed=3,
               project=str(Path(root) / "runs"), name="p9", exist_ok=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with plain_decode_calls() as plain_calls:
        kernels.reset_launch_counts()
        model = YOLO("yolo11n.yaml")
        if model.device != dev:
            raise SystemExit(f"YOLO() built its graph on {model.device}, not on {dev}")
        t1 = time.perf_counter()
        model.train(epochs=2, close_mosaic=1, **run)
        first = model.trainer
        t2 = time.perf_counter()
        resumed = YOLO("yolo11n.yaml")
        resumed.train(epochs=3, close_mosaic=1, resume=True, **run)
        second = resumed.trainer
        t3 = time.perf_counter()
        train_launches = kernels.launch_counts()["decode_box_best"]
        best = Path(root) / "runs" / "p9" / "weights" / "best.ckpt"
        loaded = YOLO(best)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        metrics = loaded.val(data=str(data), batch=P9_BATCH)
        torch.cuda.synchronize()
        val_s = time.perf_counter() - t4
        val_launches = kernels.launch_counts()["decode_box_best"] - train_launches
        results = loaded.predict(frames, imgsz=IMGSZ, batch=4, conf=CONF)
        torch.cuda.synchronize()
        n_val_batches = -(-P9_VAL // P9_BATCH)
        expected = {"decode_box_best": 3 * n_val_batches + n_val_batches + -(-len(frames) // 4),
                    "decode_xywh": 0, "int8_matmul": 0}
        launches = expect_launches("the trainer and the facade", expected)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if plain_calls:
        raise SystemExit(f"phase 9 ran the decode's plain version {len(plain_calls)} times on the card")
    if first.start_epoch != 0 or second.start_epoch != 2 or second.state.step != 3 * first.nb:
        raise SystemExit(f"the resume started at epoch {second.start_epoch}, step {second.state.step}")
    # the first epoch of each run waits for its spawned worker pool to start (and epoch 0 for cuDNN's
    # autotuning): the per-step figure reads only the later epochs, with warm workers
    epochs = first.loader_wait + second.loader_wait
    cold = {0, len(first.loader_wait)}
    for e, (wait, wall, n) in enumerate(epochs):
        print(f"  epoch {e}: {n} steps in {wall:.2f} s, {wall * 1e3 / n:.1f} ms per step, "
              f"{P9_BATCH * n / wall:.1f} img/s, loader-wait share {wait / wall:.3f} (host clock)"
              + (", first epoch of its run: the pool starts" if e in cold else ""))
    warm = [e for e in range(len(epochs)) if e not in cold]
    steps = sum(epochs[e][2] for e in warm)
    ms = sum(epochs[e][1] for e in warm) * 1e3 / steps
    print(f"phase 9 train: {ms:.1f} ms per step, {P9_BATCH * 1e3 / ms:.1f} img/s over the {steps} steps of epochs "
          f"{warm}, the epochs with warm workers (host clock, loader in the loop, {P9_WORKERS} workers); "
          f"loader-wait share {sum(epochs[e][0] for e in warm) / sum(epochs[e][1] for e in warm):.3f}; peak memory "
          f"allocated {peak_gb:.2f} GB; run 1 {t2 - t1:.1f} s, run 2 (resume) {t3 - t2:.1f} s")
    print(f"phase 9 val: {val_s * 1e3 / P9_VAL:.2f} ms per image over {P9_VAL} images (host clock, loader to "
          f"metrics); {', '.join(f'{k} {v:.4f}' for k, v in metrics.results_dict.items())}")
    print(f"phase 9 decode_box launches {launches['decode_box_best']} (expected {expected['decode_box_best']}: "
          f"{n_val_batches} per validation of 3 epochs, {n_val_batches} in val, {-(-len(frames) // 4)} predict "
          f"batches), val {val_launches}, plain-version calls {len(plain_calls)}; predict "
          f"{sum(len(r) for r in results)} detections over {len(results)} frames")

    with open(Path(root) / "runs" / "p9" / "results.csv") as f:
        rows = list(csv.DictReader(f))
    losses = [float(r[k]) for r in rows for k in ("box_loss", "cls_loss", "dfl_loss", "loss")]
    print(f"results.csv: {len(rows)} rows, columns {list(rows[0])}")
    if len(rows) != 3 or not np.isfinite(losses).all():
        raise SystemExit(f"results.csv has {len(rows)} rows or loss items that are not finite: {losses}")

    payload, meta = load_checkpoint(Path(root) / "runs" / "p9" / "weights" / "last.ckpt")
    saved = state_dict_from_jax({"params": payload["params"], "batch_stats": payload["batch_stats"]})
    diff = max((saved[k] - v.detach().cpu()).abs().max().item() for k, v in second.state.params.items())
    print(f"last.ckpt (epoch {meta['epoch']}) reloads into the trainer's params: max abs difference {diff}")
    if diff != 0 or meta["epoch"] != 2:
        raise SystemExit("last.ckpt does not hold the trainer's final parameters")

    ds = YOLODataset(str(Path(root) / "ds" / "images" / "train"), imgsz=IMGSZ, augment=True, hyp=vars(first.args), max_gt=first.args.max_gt)
    cpu_loader = DataLoader(ds, P9_BATCH, shuffle=True, seed=3, workers=0)
    cpu_loader.set_epoch(0)
    want = next(iter(cpu_loader))
    got = {k: v.cpu() for k, v in first.first_batch.items()}  # as the train step received it on the card
    same = set(got) == set(want) and torch.equal(got["img"], torch.from_numpy(want["img"]).permute(0, 3, 1, 2))
    same = same and all(np.array_equal(got[k].numpy(), want[k]) for k in want if k != "img")
    print(f"first batch the card's train step received equals the CPU loader's batch (seed 3, epoch 0), byte "
          f"for byte: {same}")
    if not same:
        raise SystemExit("the card trainer's first batch differs from the CPU loader's")
    return launches, data


# phase 10: the bf16 graph (predict and val half=True, the amp train step, YOLO.train with its default amp)
# card vs CPU, bf16 graph: cuDNN's bf16 convolutions (tensor cores) and the CPU's round apart, so the head levels
# are held to a bf16-sized norm-relative gap, and rows are compared per anchor after the decode (the box decode's
# xyxy box and best class logit for every anchor): with draw_weights' head the top 300 detections all sit in one
# or two bf16 steps of saturated score, so which of them survive is a tie-break, not a measure (printed only)
HALF_HEAD_NORM = 1e-2
HALF_BOX_PX, HALF_LOGIT, HALF_ANCHOR_MIN = 1.0, 0.1, 0.99
# the amp gradient against the float64 graph's (phase 7a's referee): with these random weights bf16 rounding,
# carried through train-mode BatchNorm over the whole depth, moves the gradient far (on the CPU at 128 px, the JAX
# package's own bf16 gradient is 0.616 of the float64 norm away, the port's 0.68: tests/test_torch_amp.py
# test_amp_gradient_noise_matches_jax). Measured on an NVIDIA H100 80GB HBM3 at 700 W: 0.927 away, cosine 0.519.
# The card's amp gradient must still point the float64 gradient's way
AMP_GRAD_F64_RTOL, AMP_GRAD_F64_COS = 1.2, 0.25


def decode_bound(feats, nc: int, out_floats: int, ops_per_anchor: int):
    """(bound ms, bound_by) of one decode call on these levels: the levels read once, float32 outputs written once."""
    b, a = feats[0].shape[0], sum(f.shape[2] * f.shape[3] for f in feats)
    return bound(sum(f.nbytes for f in feats) + b * a * out_floats * 4, b * a * ops_per_anchor, PEAK_F32_OPS_PER_S)


BOX_OPS = 4 * (6 * 16 + 1) + 12 + 8  # per anchor at nc 12, as check_decode_kernel counts them
XYWH_OPS = 4 * (6 * 16 + 1) + 10 + 4 * 12


def half_head(label, graph, run):
    """The head levels of every forward of ``graph`` in ``run()``; fails unless all are bfloat16 and contiguous."""
    import torch

    heads = head_outputs(graph, run)
    dtypes = sorted({str(f.dtype) for feats in heads for f in feats})
    print(f"{label}: {len(heads)} forwards of the bf16 graph, head level dtypes {dtypes}")
    if not heads or dtypes != [str(torch.bfloat16)] or not all(f.is_contiguous() for feats in heads for f in feats):
        raise SystemExit(f"{label}: the half graph's head is not bfloat16 contiguous levels ({dtypes})")
    return heads


def half_predict_path(dev, host, model, frames):
    """Phase 10a: predict(half=True) at batch 4: decode_box once per batch on bf16 levels, the plain
    decode never; float32 and bf16 in turns; the bf16 graph on the card against the CPU's."""
    import torch

    from bsyolo_tpu_torch import kernels
    from bsyolo_tpu_torch.kernels.decode import box_best, flatten_levels
    from bsyolo_tpu_torch.ops.letterbox import letterbox

    kw = dict(imgsz=IMGSZ, batch=4, conf=CONF)
    model.predict(frames[:4], half=True, **kw)  # warm-up: the bf16 copy of the weights, cuDNN's bf16 plans
    torch.cuda.synchronize()
    heads = half_head("predict(half=True), one batch of 4", model.half_graph(),
                      lambda: model.predict(frames[:4], half=True, **kw))
    n_batches = math.ceil(N_FRAMES / 4)
    with plain_decode_calls() as plain_calls:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = model.predict(frames, half=True, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = expect_launches("half predict", {"decode_box_best": n_batches, "decode_xywh": 0, "int8_matmul": 0})
    if plain_calls:
        raise SystemExit(f"predict(half=True) ran a decode's plain version {len(plain_calls)} times on the card")
    batch_ms = wall * 1e3 / n_batches
    print(f"predict(half=True) batch 4: {N_FRAMES / wall:.1f} img/s, {batch_ms:.1f} ms per batch (host clock, "
          f"letterbox to Results), detections per frame {[len(r) for r in res]}")
    check_finite("half predict", [r.boxes.data for r in res])
    turns = []
    for half in (False, True, True, False):
        model.predict(frames[:4], half=half, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.predict(frames, half=half, **kw)
        torch.cuda.synchronize()
        turns.append((time.perf_counter() - t0) * 1e3 / n_batches)
    print(f"float32 and bf16 predict in turns, ms per batch of 4 (host clock): float32 {turns[0]:.1f}, bf16 "
          f"{turns[1]:.1f}, bf16 {turns[2]:.1f}, float32 {turns[3]:.1f}")
    profile_once("predict(half=True), one batch of 4", lambda: model.predict(frames[:4], half=True, **kw), batch_ms)
    profile_once("predict (float32, phase 3's path) in turn, one batch of 4", lambda: model.predict(frames[:4], **kw),
                 min(turns[0], turns[3]))
    # the graph alone (NMS iterations depend on the scores, so the whole path's device work mixes both)
    xb = torch.stack([letterbox(f, (IMGSZ, IMGSZ), dev) for f in frames[:4]]).float() / 255.0
    with torch.inference_mode():
        for graph, what in ((model.half_graph(), "bf16"), (model.model, "float32")):
            graph(xb)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            graph(xb)
            torch.cuda.synchronize()
            profile_once(f"the {what} graph alone, one batch of 4", lambda: graph(xb), (time.perf_counter() - t0) * 1e3)
    spec = model.spec
    feats = heads[0]
    us = check_decode_stage(f"predict(half=True), batch of 4 (box_best on bf16 levels) "
                            f"{[tuple(f.shape[2:]) for f in feats]}",
                            lambda f: box_best(f, spec.head_strides, spec.nc, spec.reg_max), feats, "decode_box_best")
    bound_ms, bound_by = decode_bound(feats, spec.nc, 5 + spec.nc, BOX_OPS)
    print(f"  decode_box on that bf16 head: {us:.2f} us against a {bound_ms * 1e3:.2f} us bound ({bound_by})")

    x = torch.stack([letterbox(f, (IMGSZ, IMGSZ), "cpu") for f in frames[:4]]).float() / 255.0
    t0 = time.perf_counter()
    with torch.inference_mode():
        want = host.half_graph()(x)
        got = model.half_graph()(x.to(dev))
        f32 = flatten_levels(model.model(x.to(dev)))
    errs = [((g.float().cpu() - w.float()).norm() / w.float().norm()).item() for g, w in zip(got, want)]
    gap = ((flatten_levels(got).float() - f32).norm() / f32.norm()).item()
    print(f"bf16 head levels card vs CPU (batch of 4; CPU {time.perf_counter() - t0:.1f} s): "
          f"{', '.join(f'{e:.3g}' for e in errs)} of the norm (tol {HALF_HEAD_NORM}); the card's bf16 head is {gap:.3g} "
          f"of the norm from its float32 head")
    if max(errs) > HALF_HEAD_NORM or any(g.dtype != torch.bfloat16 for g in got):
        raise SystemExit("the bf16 head on the card is not the CPU's bf16 head within the tolerance")
    with torch.inference_mode():
        gb, gbest, _ = box_best(got, spec.head_strides, spec.nc, spec.reg_max)
        wb, wbest, _ = box_best(want, spec.head_strides, spec.nc, spec.reg_max)
    box_err = (gb.cpu() - wb).abs().amax(-1)
    logit_err = (gbest.cpu() - wbest).abs()
    ok = ((box_err <= HALF_BOX_PX) & (logit_err <= HALF_LOGIT)).float().mean().item()
    print(f"  decoded anchor rows card vs CPU ({box_err.numel()} anchors): {ok:.5f} with |box| <= {HALF_BOX_PX} px and "
          f"|best logit| <= {HALF_LOGIT} (needs {HALF_ANCHOR_MIN}); box err p50/p99/max "
          f"{np.quantile(box_err.numpy(), [0.5, 0.99, 1.0]).round(4).tolist()} px, best-logit err p50/p99/max "
          f"{np.quantile(logit_err.numpy(), [0.5, 0.99, 1.0]).round(4).tolist()}")
    if ok < HALF_ANCHOR_MIN:
        raise SystemExit("the card's bf16 decoded rows differ from the CPU's beyond the tolerance")
    compare_with_cpu("predict(half=True), 4 frames, printed only", [r.boxes.data for r in res[:4]],
                     [r.boxes.data for r in host.predict(frames[:4], half=True, **kw)], 1.0, 1e-2, min_fraction=0.0)
    return launches, {"device_us": us, "bound_ms": bound_ms, "bound_by": bound_by, "shape": "B4 640 bf16 head"}


def half_tta_tiled_path(model, frames):
    """Phase 10b: TTA and tiled predict on the half graph: decode_xywh three times per TTA batch and
    once per tiled call, on bf16 levels, the plain decode never."""
    import torch

    from bsyolo_tpu_torch import kernels
    from bsyolo_tpu_torch.engine.tiled import predict_tiled, tile_grid
    from bsyolo_tpu_torch.nn.heads import decode_detections

    kw = dict(imgsz=IMGSZ, batch=4, conf=CONF, half=True, augment=True)
    big = np.random.default_rng(SEED + 1).integers(0, 256, (1080, 1920, 3), dtype=np.uint8)

    def tiled():
        return predict_tiled(model.half_graph(), model.spec, big, tile=IMGSZ, conf=CONF)

    model.predict(frames[:4], **kw)  # warm-up: the 544 and 448 px plans in bf16
    tiled()
    torch.cuda.synchronize()
    passes = half_head("TTA predict(half=True), one batch of 4", model.half_graph(),
                       lambda: model.predict(frames[:4], **kw))
    if len(passes) != 3:
        raise SystemExit(f"one TTA batch ran the half graph {len(passes)} times, expected 3")
    half_head("predict_tiled on the half graph, 1080x1920", model.half_graph(), tiled)
    n_batches = math.ceil(N_FRAMES / 4)
    with plain_decode_calls() as plain_calls:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = model.predict(frames, **kw)
        torch.cuda.synchronize()
        tta_ms = (time.perf_counter() - t0) * 1e3 / n_batches
        t0 = time.perf_counter()
        dets = tiled()
        tiled_ms = (time.perf_counter() - t0) * 1e3
        launches = expect_launches("half TTA and tiled predict",
                                   {"decode_box_best": 0, "decode_xywh": 3 * n_batches + 1, "int8_matmul": 0})
    if plain_calls:
        raise SystemExit(f"TTA or tiled on the half graph ran a decode's plain version {len(plain_calls)} times")
    check_finite("half TTA predict", [r.boxes.data for r in res])
    check_finite("tiled on the half graph", [dets])
    print(f"TTA predict(half=True) batch 4: {tta_ms:.1f} ms per batch; tiled on the half graph, 1080x1920 "
          f"({len(tile_grid(1080, 1920, IMGSZ))} tiles): {tiled_ms:.1f} ms per frame, {len(dets)} detections (host clock)")
    spec = model.spec
    feats = passes[0]
    us = check_decode_stage(f"TTA pass 1 of 3 on bf16 levels (decode_detections) {[tuple(f.shape[2:]) for f in feats]}",
                            lambda f: decode_detections(f, spec.head_strides, spec.nc, spec.reg_max), feats,
                            "decode_xywh")
    bound_ms, bound_by = decode_bound(feats, spec.nc, 4 + spec.nc, XYWH_OPS)
    print(f"  decode_xywh on that bf16 head: {us:.2f} us against a {bound_ms * 1e3:.2f} us bound ({bound_by})")
    return launches, {"device_us": us, "bound_ms": bound_ms, "bound_by": bound_by, "shape": "B4 640 bf16 head"}


def half_int8_path(dev, host, model, frames):
    """Phase 10c: int8 on the half graph, batch 4: int8_matmul 74 times per forward with its bf16
    epilogue (the profiler's kernel names), int8 rows against the CPU's as phase 6 holds them."""
    import torch

    from bsyolo_tpu_torch import kernels
    from bsyolo_tpu_torch.nn.modules import quantizable_convs, set_int8_inference
    from bsyolo_tpu_torch.nn.quant import calibrate_int8
    from bsyolo_tpu_torch.ops.letterbox import letterbox

    kw = dict(imgsz=IMGSZ, batch=4, conf=CONF, half=True)
    batches = [torch.stack([letterbox(f, (IMGSZ, IMGSZ), dev) for f in frames[i : i + 4]]).float() / 255.0
               for i in range(0, N_FRAMES, 4)]
    scales = calibrate_int8(model.model, batches)
    n_convs = len(quantizable_convs(model.model))
    set_int8_inference(model.model, True, scales)
    set_int8_inference(host.model, True, scales)
    try:
        model.predict(frames[:4], **kw)  # warm-up: a new bf16 copy with the int8 mode, its weight codes
        torch.cuda.synchronize()
        half = model.half_graph()
        conv_out = []
        first = next(m for _, m in quantizable_convs(half))
        hook = first.bn.register_forward_pre_hook(lambda m, args: conv_out.append(args[0].dtype))
        try:
            heads = half_head("int8 predict(half=True), one batch of 4", half, lambda: model.predict(frames[:4], **kw))
        finally:
            hook.remove()
        n_batches = math.ceil(N_FRAMES / 4)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = model.predict(frames, **kw)
        torch.cuda.synchronize()
        batch_ms = (time.perf_counter() - t0) * 1e3 / n_batches
        launches = expect_launches("int8 predict on the half graph",
                                   {"decode_box_best": n_batches, "decode_xywh": 0, "int8_matmul": n_convs * n_batches})
        print(f"int8 predict(half=True) batch 4: {batch_ms:.1f} ms per batch (host clock); the first int8 conv "
              f"writes {conv_out[0]}; {len(heads)} forward(s) checked")
        kern = profile_once("int8 predict(half=True), one batch of 4", lambda: model.predict(frames[:4], **kw),
                            batch_ms)
        int8 = [(name, n) for name, _, n in kern if "int8_matmul_kernel" in name]
        bf16 = sum(n for name, n in int8 if "bfloat16" in name)
        print(f"  int8_matmul kernels the profiler recorded in that batch: {sum(n for _, n in int8)} (the launch "
              f"counter: {n_convs} per forward), {bf16} of them the bf16 epilogue: {sorted({name[:90] for name, _ in int8})}")
        if conv_out[0] != torch.bfloat16 or not int8 or bf16 != sum(n for _, n in int8):
            raise SystemExit("the int8 convs of the half graph did not write bfloat16 through the kernel's bf16 epilogue")
        got = [r.boxes.data for r in res]
        check_finite("int8 predict(half=True)", got)
        want = [r.boxes.data for r in host.predict(frames[:4], **kw)]
        compare_with_cpu("int8 predict(half=True), 4 frames", got[:4], want, INT8_MATCH_BOX_PX, INT8_MATCH_SCORE,
                         INT8_MATCH_MIN_FRACTION)
    finally:
        set_int8_inference(model.model, False)
        set_int8_inference(host.model, False)
    return launches


def amp_step_path(dev, model, seeded, f32_figures, referee):
    """Phase 10d: the amp train step (phase 7b on the bf16 graph): 30 steps at batch 16, its figures
    beside phase 7b's, float32 and amp in turns; one amp gradient against phase 7a's float64 referee."""
    import torch

    from bsyolo_tpu_torch.engine.train_step import init_train_state, make_train_step
    from bsyolo_tpu_torch.nn.model import set_compute_dtype

    batch4, ref_grads = referee
    model.model.load_state_dict(seeded)
    set_compute_dtype(model.model, torch.bfloat16)
    try:
        _, grads = loss_gradients(model.model, model.spec, on_device(batch4, dev), dev)
        whole = against_float64("card, amp", grads, ref_grads)
        cos = (sum((grads[n].double() * g).sum().item() for n, g in ref_grads.items())
               / (_whole_norm(grads.values()) * _whole_norm(ref_grads.values())))
        print(f"  the amp gradient is {whole:.3g} of the float64 gradient's norm away (tol {AMP_GRAD_F64_RTOL}), cosine "
              f"{cos:.3f} (at least {AMP_GRAD_F64_COS})")
        if not (whole <= AMP_GRAD_F64_RTOL and cos >= AMP_GRAD_F64_COS):
            raise SystemExit("the amp step's gradient is too far from the float64 graph's")
        model.model.load_state_dict(seeded)
        state, amp = train_path(dev, model, label="amp train")
        del state
        for key, what in (("ms", "ms per step"), ("device_ms", "ms of device work per step"), ("busy", "device busy"),
                          ("peak_gb", "GB peak memory allocated")):
            print(f"  amp vs float32 (phase 7b): {amp[key]:.3f} vs {f32_figures[key]:.3f} {what}")
        top = sorted(set(amp["kernels"]) | set(f32_figures["kernels"]),
                     key=lambda k: -max(amp["kernels"].get(k, 0), f32_figures["kernels"].get(k, 0)))[:8]
        for name in top:
            print(f"  {amp['kernels'].get(name, 0) / 1e3:8.3f} ms amp, {f32_figures['kernels'].get(name, 0) / 1e3:8.3f} "
                  f"ms float32 per step  {name[:90]}")
        cfg = train_config(model.spec, TRAIN_BATCH)
        batch = on_device(synthetic_batch(np.random.default_rng(SEED + 11), TRAIN_BATCH, (IMGSZ, IMGSZ),
                                          len(model.names)), dev)
        state = init_train_state(model.model, cfg)
        step = make_train_step(model.model, cfg)
        turns = []
        for dtype in (torch.float32, torch.bfloat16, torch.bfloat16, torch.float32):
            set_compute_dtype(model.model, dtype)
            for _ in range(2):
                state, _ = step(state, batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            for _ in range(8):
                state, _ = step(state, batch)
            torch.cuda.synchronize()
            turns.append(((time.perf_counter() - t0) * 1e3 / 8, torch.cuda.max_memory_allocated(dev) / 1e9))
        print("float32 and amp steps in turns, batch 16 (ms per step, peak GB): " + ", ".join(
            f"{name} {ms:.2f} ({gb:.2f})" for name, (ms, gb) in zip(("float32", "amp", "amp", "float32"), turns)))
    finally:
        set_compute_dtype(model.model, torch.float32)
    return amp


def amp_trainer_path(dev, data, root):
    """Phase 10e: YOLO("yolo11n.yaml").train(...) with its default amp=True on phase 9's dataset, 2 epochs
    at batch 16, then YOLO(best.ckpt).val(half=True): decode_box once per validation batch on bf16 levels."""
    from pathlib import Path

    import torch

    from bsyolo_tpu_torch import YOLO, kernels
    from bsyolo_tpu_torch.nn.model import compute_dtype

    run = dict(data=str(data), imgsz=IMGSZ, batch=P9_BATCH, plots=False, workers=P9_WORKERS, seed=3,
               project=str(Path(root) / "runs"), name="p10", exist_ok=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    n_val_batches = -(-P9_VAL // P9_BATCH)
    with plain_decode_calls() as plain_calls:
        kernels.reset_launch_counts()
        model = YOLO("yolo11n.yaml")
        t0 = time.perf_counter()
        model.train(epochs=2, close_mosaic=1, **run)
        train_s = time.perf_counter() - t0
        tr = model.trainer
        if not (tr.args.amp is True and compute_dtype(tr.model) == torch.bfloat16 and compute_dtype(model.model)
                == torch.bfloat16 and all(p.dtype == torch.float32 for p in tr.model.parameters())):
            raise SystemExit("YOLO.train with its default arguments did not train the bf16 graph over float32 weights")
        loaded = YOLO(Path(root) / "runs" / "p10" / "weights" / "best.ckpt")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        heads = head_outputs(loaded.half_graph(), lambda: loaded.val(data=str(data), batch=P9_BATCH, half=True))
        val_s = time.perf_counter() - t1
        launches = expect_launches("amp training and val(half=True)",
                                   {"decode_box_best": 2 * n_val_batches + n_val_batches, "decode_xywh": 0,
                                    "int8_matmul": 0})
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if plain_calls or not heads or any(f.dtype != torch.bfloat16 for feats in heads for f in feats):
        raise SystemExit(f"val(half=True) ran a plain decode ({len(plain_calls)}) or a head that is not bfloat16")
    bound_ms, bound_by = decode_bound(heads[0], loaded.spec.nc, 5 + loaded.spec.nc, BOX_OPS)
    print(f"  decode_box on the validation batch's bf16 head {tuple(heads[0][0].shape)}...: bound {bound_ms * 1e3:.2f} us "
          f"({bound_by})")
    for e, (wait, wall, n) in enumerate(tr.loader_wait):
        print(f"  amp epoch {e}: {n} steps in {wall:.2f} s, {wall * 1e3 / n:.1f} ms per step, {P9_BATCH * n / wall:.1f} "
              f"img/s, loader-wait share {wait / wall:.3f} (host clock)" + (", the pool starts" if e == 0 else ""))
    wait, wall, n = tr.loader_wait[1]
    losses = [float(v) for v in tr.epoch_metrics.values()]
    print(f"phase 10e train (amp): {wall * 1e3 / n:.1f} ms per step, {P9_BATCH * n / wall:.1f} img/s over the {n} "
          f"steps of epoch 1, the epoch with warm workers; loader-wait share {wait / wall:.3f}; peak memory allocated "
          f"{peak_gb:.2f} GB; {train_s:.1f} s for 2 epochs; val(half=True) {val_s * 1e3 / P9_VAL:.2f} ms per image, "
          f"{loaded.metrics.results_dict}")
    if not np.isfinite(losses).all():
        raise SystemExit(f"amp training gave loss items that are not finite: {tr.epoch_metrics}")
    return launches


# phase 11: the product path (YOLO.track, the GRFB-UNet segmenter, the occlusion rule and the dwell timer)
P11_HW, P11_FRAMES, P11_FPS = (720, 1280), 48, 25
P11_CONF, P11_DWELL_S = 0.25, 0.5  # the pipeline's default conf; a dwell the 1.92 s clip can reach
# random weights box most of the frame, where a car hides a few per cent of the paving mask at most: a low
# occlusion threshold (the application's is 0.7) makes the rule and the dwell timer fire within the clip
P11_OCCLUSION = 0.02
P11_SEG = dict(num_classes=2, base_c=32, resize=565)  # the application's segmenter (sys/videobytetrack.py:220)
P11_CPU_FRAMES = 8  # frames of the decision step run again on the CPU
# frames of the decision step under torch.profiler: the segmenter's cuDNN convolutions launch about 33,000
# kernels per frame, and the profiler takes about 10 s per frame to process them
P11_PROFILE_FRAMES = 4
P11_LOGIT_NORM = 1e-3  # GRFB-UNet logits, card vs CPU on one input: cuDNN's float32 sums in another order
# the segmenter's input, card vs CPU: the resize is integer arithmetic (equal); the normalization is 3 float32
# operations, correctly rounded on both (1 ulp at the largest input, about 23, is 1.9e-6)
P11_INPUT_ATOL = 2e-6
# segmenter masks, card vs CPU: the networks' inputs are equal (an integer resize), so masks differ only where
# the two class logits nearly tie
P11_MASK_AGREEMENT = 0.999
# a tracked box is the track's Kalman state, which overshoots a detection clipped at the frame's border by its
# velocity; a tracked box must meet the frame and stay within a quarter of its short side of it
P11_BOX_MARGIN_PX = 180


def product_clip(seed: int):
    """P11_FRAMES seeded 720x1280 BGR frames: a grey road of coarse seeded texture with a yellow strip of
    tactile paving (rows 400 to 470); frame 0 is the empty road, then three filled rectangles move, and the
    first stops across the strip at frame 20."""
    rng = np.random.default_rng(seed)
    h, w = P11_HW
    road = np.clip(rng.normal(96, 8, (h // 8, w // 8)), 0, 255).astype(np.uint8)
    road = np.repeat(np.repeat(road, 8, 0), 8, 1)[..., None].repeat(3, 2)
    road[400:470] = (40, 210, 225)
    # x0, y0, width, height, px per frame (x), colour (BGR), frame it stops at
    cars = ((60, 330, 220, 160, 24, (200, 190, 185), 20), (1100, 120, 180, 120, -18, (60, 60, 200), None),
            (300, 560, 200, 130, 10, (200, 80, 40), None))
    frames = [road]
    for i in range(1, P11_FRAMES):
        f = road.copy()
        for x0, y0, cw, ch, vx, colour, stop in cars:
            x = int(x0 + vx * (min(i, stop) if stop else i))
            f[y0: y0 + ch, max(x, 0): max(x + cw, 0)] = colour
        frames.append(f)
    return frames


class HostTimer:
    """Wraps a callable that returns host data (so the device work is done when it returns) and sums
    the host seconds of its calls."""

    def __init__(self, fn):
        self.fn, self.seconds, self.calls = fn, 0.0, 0

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return out


@contextlib.contextmanager
def recorded_tracking():
    """(detections before tracking, tracked rows) of every frame ``YOLO.track`` hands its tracker while
    the block runs."""
    from bsyolo_tpu_torch import trackers

    frames, real = [], trackers.track_results

    def record(tracker, result):
        out = real(tracker, result)
        frames.append((result.boxes.data.copy(), out.boxes.data.copy()))
        return out

    trackers.track_results = record
    try:
        yield frames
    finally:
        trackers.track_results = real


def draw_segmenter_weights(host, card, frame, seed: int) -> None:
    """Seeded weights for the segmenter on the CPU (``draw_weights``' draws: convs at U(+-sqrt(3 / fan_in)),
    BatchNorm statistics away from the identity), copied to the card's, then the second class's output bias
    moved in both so that half of ``frame``'s pixels are foreground: random weights otherwise give one class
    almost everywhere, and a mask of one class holds nothing to compare."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in host.model.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            if p.dim() >= 2:
                p.copy_(torch.empty(p.shape).uniform_(-1, 1, generator=g) * math.sqrt(3.0 / p[0].numel()))
            elif name.endswith(("running_var", "bn.weight")):
                p.copy_(torch.empty(p.shape).uniform_(0.5, 1.5, generator=g))
            else:
                p.copy_(torch.empty(p.shape).uniform_(-0.1, 0.1, generator=g))
        card.model.load_state_dict(host.model.state_dict())
        logits = card.model(card.network_input(frame))[0]
        shift = (logits[0] - logits[1]).median().cpu()
        host.model.out_conv.bias[1] += shift
        card.model.out_conv.bias[1] += shift.to(card.device)


def product_models(dev, frame):
    """yolo11n with draw_weights and the application's segmenter (draw_segmenter_weights on ``frame``), on
    the card and on the CPU."""
    from types import SimpleNamespace

    import torch

    from bsyolo_tpu_torch import YOLO
    from bsyolo_tpu_torch.app import BlindwaySegmenter

    host = YOLO("yolo11n.yaml", device="cpu", seed=SEED)
    draw_weights(host.model, SEED + 11)
    card = YOLO("yolo11n.yaml", seed=SEED)
    card.model.load_state_dict(host.model.state_dict())
    seg_host = BlindwaySegmenter(**P11_SEG, seed=SEED, device="cpu")
    seg_card = BlindwaySegmenter(**P11_SEG, seed=SEED)
    draw_segmenter_weights(seg_host, seg_card, frame, SEED + 11)
    if seg_card.device != dev or next(seg_card.model.parameters()).device != dev:
        raise SystemExit(f"BlindwaySegmenter() built its network on {seg_card.device}, not on {dev}")
    if not all(torch.equal(a.cpu(), b) for a, b in zip(seg_card.model.state_dict().values(),
                                                          seg_host.model.state_dict().values())):
        raise SystemExit("the card's and the CPU's segmenter weights differ")
    n = sum(p.numel() for p in seg_card.model.parameters())
    print(f"GRFB-UNet: {n} params (base_c {P11_SEG['base_c']}, {P11_SEG['num_classes']} classes, resize "
          f"{P11_SEG['resize']}, weights drawn with seed {SEED + 11}); yolo11n with draw_weights (seed {SEED + 11}); "
          f"clip {P11_FRAMES} frames {P11_HW[0]}x{P11_HW[1]} at {P11_FPS} fps")
    return SimpleNamespace(host=host, card=card, seg_host=seg_host, seg_card=seg_card)


def segmenter_against_cpu(dev, m, frames):
    """Phase 11a: the segmenter on 4 frames on the card and on the CPU: the networks' inputs within
    P11_INPUT_ATOL, the logits on the same input within P11_LOGIT_NORM of their norm, the masks within
    P11_MASK_AGREEMENT; the card's time per frame, one call profiled, its peak memory."""
    import torch

    agree, errs, in_errs = [], [], []
    for f in frames[::P11_FRAMES // 4]:
        x = m.seg_host.network_input(f)
        x_card = m.seg_card.network_input(f)
        in_errs.append((x_card.cpu() - x).abs().max().item())
        if in_errs[-1] > P11_INPUT_ATOL:
            raise SystemExit(f"the segmenter's input differs between card and CPU by {in_errs[-1]:.3g}")
        with torch.inference_mode():
            want = m.seg_host.model(x)
            got = m.seg_card.model(x_card)
        errs.append(((got.cpu() - want).norm() / want.norm()).item())
        mask, ref = m.seg_card(f), m.seg_host.mask_from_logits(want, f.shape[:2])
        if mask.shape != P11_HW or mask.dtype != np.uint8 or not set(np.unique(mask)) <= {0, 255}:
            raise SystemExit(f"the segmenter's mask is not a {P11_HW} uint8 {{0, 255}} map: {mask.shape} {mask.dtype}")
        agree.append((mask == ref).mean())
    ms = []
    for f in frames[1:6]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f32_mask = m.seg_card(f)
        ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.reset_peak_memory_stats(dev)
    m.seg_card(frames[1])
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"phase 11a segmenter, card vs CPU on {len(agree)} frames ({tuple(x.shape[2:])} network input, max |diff| "
          f"{max(in_errs):.3g}): logits {', '.join(f'{e:.3g}' for e in errs)} of their norm (gate {P11_LOGIT_NORM}); "
          f"masks agree on {', '.join(f'{a:.6f}' for a in agree)} of the pixels (gate {P11_MASK_AGREEMENT}); "
          f"foreground share {(mask > 0).mean():.3f}; on the card {', '.join(f'{t:.1f}' for t in ms)} ms per frame "
          f"(host clock, frame to host mask), peak memory allocated {peak_gb:.2f} GB for one call")
    if max(errs) > P11_LOGIT_NORM or min(agree) < P11_MASK_AGREEMENT:
        raise SystemExit("the segmenter on the card disagrees with the CPU beyond its gates")
    profile_once("the segmenter, one 720x1280 frame", lambda: m.seg_card(frames[1]), float(np.median(ms)))
    # the same call with TF32 convolutions, PyTorch's default (the smoke keeps TF32 off to compare with the CPU):
    # cuDNN's heuristics then choose other algorithms
    torch.backends.cudnn.allow_tf32 = True
    try:
        m.seg_card(frames[1])
        tf32 = []
        for f in frames[1:6]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tf32_mask = m.seg_card(f)
            tf32.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.reset_peak_memory_stats(dev)
        m.seg_card(frames[1])
        tf32_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        print(f"  with TF32 convolutions: {', '.join(f'{t:.1f}' for t in tf32)} ms per frame, peak memory {tf32_gb:.2f} "
              f"GB for one call, the mask of frame 5 equal to float32's on {(tf32_mask == f32_mask).mean():.6f} of the pixels")
        profile_once("the segmenter with TF32, one 720x1280 frame", lambda: m.seg_card(frames[1]), float(np.median(tf32)))
    finally:
        torch.backends.cudnn.allow_tf32 = False


def decision_run(detector, segmenter, frames, tracker="bytetrack.yaml", profile_frames: int = 0):
    """The pipeline's decision step over ``frames`` from a fresh tracker, on the 25 fps video clock:
    (events, seconds per frame, the detector's and the segmenter's timers, recorded tracking). With
    ``profile_frames``, only that many frames, under torch.profiler; returns its profile instead of the
    timers."""
    from types import SimpleNamespace

    from bsyolo_tpu_torch.app import ParkingViolationPipeline

    detector._tracker = None
    idx = [0]
    track, seg = HostTimer(detector.track), HostTimer(segmenter)
    pipe = ParkingViolationPipeline(SimpleNamespace(track=track, names=detector.names), seg, conf=P11_CONF,
                                    tracker=tracker, dwell_seconds=P11_DWELL_S, occlusion_threshold=P11_OCCLUSION,
                                    clock=lambda: idx[0] / P11_FPS)
    pipe.prepare_background(frames[0])
    track.seconds = seg.seconds = seg.calls = 0
    events, walls = [], []

    def run():
        events.clear()
        walls.clear()
        for i, f in enumerate(frames[:profile_frames or None]):
            idx[0] = i
            t0 = time.perf_counter()
            events.append(pipe.decide(f, i)[0])
            walls.append(time.perf_counter() - t0)

    if profile_frames:
        return events, walls, profiled(run)
    with recorded_tracking() as tracked:
        run()
    return events, walls, track, seg, tracked


def check_events(events):
    """Boxes that meet the frame, within P11_BOX_MARGIN_PX of it, integer ids, ``elapsed`` not falling while
    an id's long violation goes on; returns (frames with tracked rows, rows, violations, long flags, the
    largest overshoot in px)."""
    h, w = P11_HW
    last, over = {}, 0
    for e in events:
        for t in e["tracks"]:
            x1, y1, x2, y2 = t["box"]
            if not (isinstance(t["id"], int) and x1 < x2 and y1 < y2 and x1 < w and y1 < h and x2 > 0 and y2 > 0):
                raise SystemExit(f"frame {e['frame']}: malformed tracked row {t}")
            over = max(over, -x1, -y1, x2 - w, y2 - h)
        for v in e["violations"]:
            prev = last.get(v["id"])
            if v["long"] and prev is not None and prev[0] == e["frame"] - 1 and v["elapsed"] < prev[1]:
                raise SystemExit(f"id {v['id']}: elapsed fell from {prev[1]} to {v['elapsed']} in a long violation")
            last[v["id"]] = (e["frame"], v["elapsed"]) if v["long"] else (None, 0.0)
    if over > P11_BOX_MARGIN_PX:
        raise SystemExit(f"a tracked box lies {over} px outside the frame")
    n_viol = sum(len(e["violations"]) for e in events)
    n_long = sum(v["long"] for e in events for v in e["violations"])
    return sum(bool(e["tracks"]) for e in events), sum(len(e["tracks"]) for e in events), n_viol, n_long, over


def tracked_against_cpu(card_tracked, host_tracked):
    """Phase 11c: the card's tracked rows on the first frames against the CPU's (compare_with_cpu's pairing,
    and the same id on paired rows), and the replay: the card's detections fed to a fresh CPU BYTETracker
    give exactly the card's tracked rows. Returns (paired fraction, ids equal on the paired rows, replay
    exact)."""
    from bsyolo_tpu_torch.engine.results import Results
    from bsyolo_tpu_torch.trackers import create_tracker, track_results

    def six(rows):  # x1, y1, x2, y2, id, conf, cls -> x1, y1, x2, y2, conf, cls (a frame without boxes has 6)
        return rows[:, [0, 1, 2, 3, 5, 6]] if rows.shape[1] == 7 else rows

    n_rows = n_pairs = same_id = 0
    for (_, got), (_, want) in zip(card_tracked, host_tracked):
        pairs = match_pairs(six(got), six(want))
        n_rows += max(len(got), len(want))
        n_pairs += len(pairs)
        same_id += sum(got[i, 4] == want[j, 4] for i, j, _, _ in pairs)
    tracker, replay_exact = create_tracker("bytetrack.yaml"), True
    for dets, tracked in card_tracked:
        replay = track_results(tracker, Results(np.zeros((*P11_HW, 3), np.uint8), "replay", {}, boxes=dets))
        replay_exact &= bool(np.array_equal(replay.boxes.data, tracked))
    return n_pairs / max(n_rows, 1), same_id / max(n_pairs, 1), replay_exact


def product_path(dev):
    """Phase 11: the parking-violation product path at full width on the card (module docstring)."""
    import tempfile

    import torch
    from torch.autograd import DeviceType

    from bsyolo_tpu_torch import kernels

    frames = product_clip(SEED + 11)
    m = product_models(dev, frames[0])
    t11 = time.perf_counter()
    segmenter_against_cpu(dev, m, frames)
    print(f"  phase 11a in {time.perf_counter() - t11:.1f} s")
    t11 = time.perf_counter()

    # (b) the decision step over the clip on the card: warm-up on 2 frames, then the counted run
    decision_run(m.card, m.seg_card, frames[:2])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with plain_decode_calls() as plain_calls:
        kernels.reset_launch_counts()
        events, walls, track, seg, card_tracked = decision_run(m.card, m.seg_card, frames)
        launches = expect_launches("product (decision step)", {"decode_box_best": P11_FRAMES, "decode_xywh": 0,
                                                               "int8_matmul": 0})
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if plain_calls:
        raise SystemExit(f"the product path ran the decode's plain version {len(plain_calls)} times on the card")
    with_rows, n_rows, n_viol, n_long, over = check_events(events)
    if with_rows < 0.75 * P11_FRAMES or seg.calls < 1:
        raise SystemExit(f"the product run is vacuous: tracked rows on {with_rows} of {P11_FRAMES} frames, "
                         f"{seg.calls} segmentations")
    wall = sum(walls)
    ms = wall * 1e3 / P11_FRAMES
    track_ms, seg_ms = track.seconds * 1e3 / P11_FRAMES, seg.seconds * 1e3 / P11_FRAMES
    _, walls_p, prof = decision_run(m.card, m.seg_card, frames, profile_frames=P11_PROFILE_FRAMES)
    busy_s = sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA) / 1e6
    print(f"phase 11b decision step on the card ({card_line()}): {P11_FRAMES} frames, {ms:.2f} ms per frame (host "
          f"clock): track (predict and tracker) {track_ms:.2f}, segment {seg_ms:.2f} ({seg.calls} calls), rule, "
          f"timer and event {ms - track_ms - seg_ms:.2f}; device busy {busy_s / sum(walls_p):.3f} of the profiled "
          f"wall time of the clip's first {P11_PROFILE_FRAMES} frames ({busy_s * 1e3:.1f} ms of device work in "
          f"{sum(walls_p) * 1e3:.1f} ms); peak memory allocated {peak_gb:.2f} GB")
    print(f"  events: tracked rows on {with_rows} of {P11_FRAMES} frames, {n_rows} rows, "
          f"{len({t['id'] for e in events for t in e['tracks']})} ids, {n_viol} violations, {n_long} long "
          f"(occlusion threshold {P11_OCCLUSION}, dwell {P11_DWELL_S} s); largest box overshoot of the frame {over} px; "
          f"{time.perf_counter() - t11:.1f} s for the three runs")

    t11 = time.perf_counter()
    # (c) the first frames' tracked rows against the port's on the CPU (YOLO.track as the decision step calls it)
    m.host._tracker = None
    with recorded_tracking() as host_tracked:
        m.host.track(frames[:P11_CPU_FRAMES], persist=True, conf=P11_CONF, tracker="bytetrack.yaml")
    compare_with_cpu("product, detections before tracking", [d for d, _ in card_tracked[:P11_CPU_FRAMES]],
                     [d for d, _ in host_tracked])
    frac, same_id, replay = tracked_against_cpu(card_tracked[:P11_CPU_FRAMES], host_tracked)
    print(f"phase 11c first {P11_CPU_FRAMES} frames, card vs CPU: {frac:.4f} of the tracked rows paired (same "
          f"class, |box| <= {MATCH_BOX_PX} px, |score| <= {MATCH_SCORE}), the same id on {same_id:.4f} of the "
          f"pairs; replay of the card's detections through a fresh CPU BYTETracker: "
          f"{'exactly the card rows' if replay else 'DIFFERENT rows'}; {time.perf_counter() - t11:.1f} s")
    if not ((frac >= MATCH_MIN_FRACTION and same_id == 1.0) or replay):  # the ids; the detections are held above
        raise SystemExit("the card's tracked rows match neither the CPU's nor the replay of its own detections")

    # (d) YOLO.track with BoT-SORT (ReID on, no camera-motion compensation) over 8 frames, persist=True
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bot_") as d:
        cfg = Path(d) / "botsort_reid.yaml"
        cfg.write_text("tracker_type: botsort\ntrack_high_thresh: 0.25\ntrack_low_thresh: 0.1\nnew_track_thresh: 0.25"
                       "\ntrack_buffer: 30\nmatch_thresh: 0.8\nfuse_score: True\ngmc_method: none\n"
                       "proximity_thresh: 0.5\nappearance_thresh: 0.25\nwith_reid: True\n")
        m.card._tracker = None
        with plain_decode_calls() as plain_calls:
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            results = m.card.track(frames[16:24], persist=True, tracker=str(cfg))
            bot_ms = (time.perf_counter() - t0) * 1e3 / 8
            bot = expect_launches("YOLO.track (BoT-SORT)", {"decode_box_best": 8, "decode_xywh": 0, "int8_matmul": 0})
    if plain_calls or type(m.card._tracker).__name__ != "BOTSORT" or not m.card._tracker.with_reid:
        raise SystemExit("YOLO.track(BoT-SORT with ReID) ran a plain decode or another tracker")
    if not all(r.boxes.is_track and np.isfinite(r.boxes.data).all() for r in results if len(r)) or \
            sum(len(r) for r in results) == 0:
        raise SystemExit("YOLO.track(BoT-SORT) gave no tracked rows, or rows that are not finite")
    print(f"phase 11d YOLO.track(BoT-SORT, ReID, gmc none, persist=True): 8 frames, {bot_ms:.2f} ms per frame (host "
          f"clock), tracked rows per frame {[len(r) for r in results]}")
    return {k: launches[k] + bot[k] for k in launches}


# phase 12: real photos. The port's JPEG codec against digests of OpenCV 5.0's arrays and bytes (cv2.imread
# and cv2.imencode at quality 95, libjpeg-turbo 3.1), recomputed with cv2 by tests/test_torch_jpeg.py; then
# YOLO.train, val(save_json, save_txt), predict(save_txt, save_crop) and embed on the bsyolo8 photos.
PHOTOS = Path(__file__).resolve().parent / "tests" / "fixtures" / "bsyolo8"
# photo -> (h, w, sha256 of cv2.imread's array, sha256 of cv2.imencode(".jpg", that array, quality 95))
PHOTO_DIGESTS = {
    "0.jpg": (427, 320, "47a519367f1e757525e305b7efd3ed3aabcc8d0d9a8973d758c9ae7463f1a01b",
              "654481713cdae66242390a7f1928caf5a47c2d9c335a4ffa2198c87820e971e5"),
    "1.jpg": (478, 320, "6cf1cf3a51cf083b1ad7ba82e6ea81d698da0e0e81caf0796479d0a973a18303",
              "75b1f224386b804505db6525cdb2593ac6ad27a679cbfde7dff20056595f0040"),
    "2.jpg": (427, 320, "d280b7cf1f7071efa26baa574fb31ee5ce4e7c5e0589f6f26f7b310987d437bf",
              "f43b2228d453d093b1e9cd31740aa60f09ed9340aa42f61568134320a4ee6b5d"),
    "3.jpg": (431, 320, "3d58845a74a91c68414b30c23237a850f21ef30cb9cef8e6182acb6169175f0e",
              "1599ecdd9a172993a352b211c5b2300f427b0d98f680b638b0ec7f7f4a712d24"),
    "4.jpg": (331, 320, "e596463a02e234c86d5939c8feee8ec8de212bfcb0510821084a8ab9379e65ba",
              "baf8e6b715d1992cbe6027c2cb557e7fa7abd8a008f42e37c512db5f7617ac61"),
    "5.jpg": (427, 320, "b913f91734261751cf8a07174aeb3a3ad0d1e9455961d561ff63b99fa45e2dac",
              "256f226f9a86c832641e64497c5142a8842f8c39de38d8ce44c7a745a6dfc4b6"),
    "6.jpg": (427, 320, "c6977c776c0e4e1af9fa81825819ce0572b2eea5c34c3d56177422d39ae28ada",
              "efc081d2553b29a40ea24e88cf774abae4e971004ac33ec7bb0adc5d1380bb75"),
    "7.jpg": (427, 320, "3213437fb574a7a0644e9706988b837790f0f374a2fa8a1930a32984a52793c7",
              "d5ba801f685efc3e7db4aec5df8d4f8feb8fdc8cafd6b1b9985a2873774fb854"),
}
P12_TRAIN = dict(imgsz=320, epochs=2, batch=8, workers=2, plots=False, seed=3)
P12_TRAIN_REPEAT = 16  # the train list holds each photo this many times: 16 steps per epoch at batch 8
P12_PREDICT_BATCH = 4
P12_STREAM_REPEAT = 64  # the rate's directory holds each photo this many times: 128 batches of 4
EMBED_RTOL = 1e-4  # pooled features, card vs CPU (norm of the difference over the CPU's norm), TF32 off


def codec_checks():
    """Phase 12 (a) and (b): decode each photo and re-encode it at quality 95; both against the digests."""
    import importlib.util
    import hashlib as _hashlib

    from bsyolo_tpu_torch.data.imread import imread
    from bsyolo_tpu_torch.data.jpeg import encode_jpeg
    from bsyolo_tpu_torch.kernels import build

    try:
        has_cv2 = importlib.util.find_spec("cv2") is not None
    except (ImportError, ValueError):
        has_cv2 = False
    build.compile_all(["jpeg"])  # built in phase 1 already: this records the reuse
    rec = build.BUILD_LOG["jpeg"]
    cxx = build.cxx()
    print(f"phase 12 codec: {rec['library']} built by {rec.get('compiler') or 'an earlier run (reused)'}; this "
          f"machine's compiler {cxx} ({build.cxx_version(cxx)}); OpenCV (cv2) importable here: "
          f"{'yes' if has_cv2 else 'no'}")
    dec_ms, enc_ms, bad = [], [], []
    for name, (h, w, want_px, want_jpg) in PHOTO_DIGESTS.items():
        path = PHOTOS / "images" / "train" / name
        img = imread(path)
        t0 = time.perf_counter()
        for _ in range(10):
            imread(path)
        dec_ms.append((time.perf_counter() - t0) * 100)
        data = encode_jpeg(img, 95)
        t0 = time.perf_counter()
        for _ in range(10):
            encode_jpeg(img, 95)
        enc_ms.append((time.perf_counter() - t0) * 100)
        got_px, got_jpg = _hashlib.sha256(img.tobytes()).hexdigest(), _hashlib.sha256(data).hexdigest()
        if img.shape != (h, w, 3) or got_px != want_px:
            bad.append(f"decode {name}: {img.shape} {got_px[:16]} (want {(h, w, 3)} {want_px[:16]})")
        if got_jpg != want_jpg:
            bad.append(f"encode {name}: {got_jpg[:16]} (want {want_jpg[:16]})")
    print(f"phase 12a decode: {len(PHOTO_DIGESTS)} photos byte-equal to cv2.imread's digests: {not bad}; "
          f"{np.mean(dec_ms):.3f} ms per photo (host clock, one thread, file read included; per photo "
          f"{', '.join(f'{v:.3f}' for v in dec_ms)})")
    print(f"phase 12b encode at quality 95: byte-equal to cv2.imencode's digests: {not bad}; "
          f"{np.mean(enc_ms):.3f} ms per photo (host clock, one thread)")
    if bad:
        raise SystemExit("the JPEG codec disagrees with OpenCV's digests: " + "; ".join(bad))


def repeated_photos(d: Path, repeat: int, labels: bool = False):
    """``d``/images/train holding each bsyolo8 photo ``repeat`` times as ``<k>_<stem>.jpg`` (hard links where
    the file system allows, else copies), with their label files under ``d``/labels/train; the image paths."""
    import os
    import shutil

    (d / "images" / "train").mkdir(parents=True)
    if labels:
        (d / "labels" / "train").mkdir(parents=True)
    paths = []
    for k in range(repeat):
        for src in sorted((PHOTOS / "images" / "train").glob("*.jpg")):
            dst = d / "images" / "train" / f"{k:03d}_{src.name}"
            try:
                os.link(src, dst)
            except OSError:
                shutil.copyfile(src, dst)
            if labels:
                shutil.copyfile(PHOTOS / "labels" / "train" / f"{src.stem}.txt",
                                d / "labels" / "train" / f"{dst.stem}.txt")
            paths.append(dst)
    return sorted(paths)


def photo_train_val(dev, root):
    """Phase 12 (c): YOLO.train on the bsyolo8 photos 16 times over (validated on the 8), then
    val(save_json, save_txt) on the 8; returns the launches."""
    import json as _json

    import torch

    from bsyolo_tpu_torch import YOLO, kernels

    data = str(PHOTOS / "bsyolo8.yaml")
    stems = sorted(p.stem for p in (PHOTOS / "images" / "train").glob("*.jpg"))
    n_train = len(repeated_photos(root / "train_data", P12_TRAIN_REPEAT, labels=True))
    train_yaml = root / "train_data" / "bsyolo8x16.yaml"
    train_yaml.write_text(f"path: {root / 'train_data'}\ntrain: images/train\nval: {PHOTOS / 'images' / 'train'}\n"
                          "nc: 3\nnames:\n  0: car\n  1: person\n  2: motorcycle\n")
    with plain_decode_calls() as plain_calls:
        kernels.reset_launch_counts()
        model = YOLO("yolo11n.yaml")
        t0 = time.perf_counter()
        model.train(data=str(train_yaml), project=str(root / "runs"), name="p12", exist_ok=True, **P12_TRAIN)
        train_s = time.perf_counter() - t0
        n_val = -(-len(stems) // P12_TRAIN["batch"])
        trained = expect_launches("YOLO.train on bsyolo8", {"decode_box_best": P12_TRAIN["epochs"] * n_val,
                                                             "decode_xywh": 0, "int8_matmul": 0})
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = model.val(data=data, batch=16, save_json=True, save_txt=True, save_dir=str(root / "val"))
        torch.cuda.synchronize()
        val_s = time.perf_counter() - t0
        val = expect_launches("val(save_json, save_txt) on bsyolo8", {"decode_box_best": -(-len(stems) // 16),
                                                                      "decode_xywh": 0, "int8_matmul": 0})
    if plain_calls:
        raise SystemExit(f"phase 12 ran the decode's plain version {len(plain_calls)} times on the card")
    for e, (wait, wall, n) in enumerate(model.trainer.loader_wait):
        print(f"  epoch {e}: {n} steps in {wall:.2f} s, {wall * 1e3 / n:.1f} ms per step, loader-wait share "
              f"{wait / wall:.3f} (host clock{', the worker pool starts' if e == 0 else ''})")
    wait, wall, n = model.trainer.loader_wait[-1]
    print(f"phase 12c YOLO.train on bsyolo8 x{P12_TRAIN_REPEAT} ({n_train} photos; {card_line()}): {P12_TRAIN}, "
          f"{train_s:.1f} s in all; last epoch {n} steps, {wall * 1e3 / n:.1f} ms per step, loader-wait share "
          f"{wait / wall:.3f} (host clock)")
    labels = sorted(p.stem for p in (root / "val" / "labels").glob("*.txt"))
    preds = _json.loads((root / "val" / "predictions.json").read_text())
    ids = sorted({str(p["image_id"]) for p in preds})
    print(f"phase 12c val: {val_s * 1e3 / len(stems):.2f} ms per image (host clock); {len(labels)} label files, "
          f"{len(preds)} predictions.json rows over image ids {ids}; "
          f"{', '.join(f'{k} {v:.4f}' for k, v in metrics.results_dict.items())}")
    if labels != stems or ids != stems:
        raise SystemExit(f"val(save_json, save_txt) wrote labels {labels} and image ids {ids}, expected {stems}")
    if not all(np.isfinite(p["bbox"]).all() and 0 < p["score"] <= 1 for p in preds):
        raise SystemExit("predictions.json holds boxes or scores that are not finite")
    return {k: trained[k] + val[k] for k in trained}


def serial_predict(p, paths):
    """Predict ``paths`` with predictor ``p``'s settings in one thread, without the reader thread: each batch
    decoded, then letterboxed, run and turned into results (the order a predictor without a reader keeps)."""
    from bsyolo_tpu_torch.data.imread import imread
    from bsyolo_tpu_torch.engine.predictor import _stack
    from bsyolo_tpu_torch.ops.letterbox import letterbox

    out = []
    for i in range(0, len(paths), p.batch):
        chunk = paths[i:i + p.batch]
        frames = [imread(f) for f in chunk]
        lbs = [letterbox(f, (p.imgsz, p.imgsz), p.device) for f in frames]
        lbs += [lbs[-1]] * (p.batch - len(lbs))
        dets = p.forward(_stack(lbs)).cpu().numpy()
        out += [p._to_results(dets[k], f, str(path)) for k, (f, path) in enumerate(zip(frames, chunk))]
    return out


def photo_rate(card, root, args):
    """Phase 12 (d), the rate: predict over the photos 64 times over, from files through the reader thread,
    from the same frames decoded beforehand, and decoding then running each batch in one thread, in turns;
    returns the launches of the reader-thread runs."""
    from bsyolo_tpu_torch import kernels
    from bsyolo_tpu_torch.data.imread import imread

    paths = repeated_photos(root / "stream", P12_STREAM_REPEAT)
    n, n_batches = len(paths), -(-len(paths) // P12_PREDICT_BATCH)
    frames = [imread(f) for f in paths]
    rates = {"files": [], "serial": [], "arrays": []}
    waits, launches = [], {}
    for kind in ("files", "serial", "arrays", "serial", "files"):
        with plain_decode_calls() as plain_calls:
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            if kind == "serial":
                got = serial_predict(card.predictor, paths)
            else:
                got = card.predict(str(root / "stream" / "images" / "train") if kind == "files" else frames, **args)
            wall = time.perf_counter() - t0
            counted = expect_launches(f"predict over {n} photos ({kind})",
                                      {"decode_box_best": n_batches, "decode_xywh": 0, "int8_matmul": 0})
        if plain_calls:
            raise SystemExit(f"phase 12 predict ({kind}) ran the decode's plain version on the card")
        if len(got) != n or (kind != "arrays" and [str(r.path) for r in got] != [str(f) for f in paths]):
            raise SystemExit(f"predict over {n} photos ({kind}) gave {len(got)} results or another order")
        if kind == "files":
            launches = {k: launches.get(k, 0) + v for k, v in counted.items()}
            waits.append(card.predictor.reader_wait / card.predictor.wall)
        rates[kind].append(n / (wall if kind == "serial" else card.predictor.wall))
    print(f"phase 12d predict rate ({card_line()}): {n} photos at batch {P12_PREDICT_BATCH}, imgsz {IMGSZ}, "
          f"{n_batches} batches, in turns files, serial, arrays, serial, files (host clock):")
    print(f"  from files through the reader thread: {', '.join(f'{r:.1f}' for r in rates['files'])} img/s over the "
          f"stream, reader-wait share {', '.join(f'{w:.3f}' for w in waits)}")
    print(f"  decode then run, one thread (no reader thread): {', '.join(f'{r:.1f}' for r in rates['serial'])} img/s")
    print(f"  frames decoded beforehand (no decode): {rates['arrays'][0]:.1f} img/s")
    return launches


def photo_predict(dev, root):
    """Phase 12 (d): predict(save_txt, save_crop) and embed over the photos' directory on the card, against
    the CPU, and the rate over the photos 64 times over; returns the launches."""
    import torch

    from bsyolo_tpu_torch import YOLO, kernels
    from bsyolo_tpu_torch.data.imread import imread

    source = str(PHOTOS / "images" / "train")
    n = len(PHOTO_DIGESTS)
    host = YOLO("yolo11n.yaml", device="cpu", seed=SEED)
    draw_weights(host.model, SEED + 12)
    card = YOLO("yolo11n.yaml", seed=SEED)
    card.model.load_state_dict(host.model.state_dict())
    args = dict(imgsz=IMGSZ, batch=P12_PREDICT_BATCH, conf=CONF)
    card.predict(source, **args)  # warm-up
    torch.cuda.synchronize()
    with plain_decode_calls() as plain_calls:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        got = card.predict(source, save_txt=True, save_conf=True, save_crop=True, project=str(root), name="pred",
                           **args)
        wall = time.perf_counter() - t0
        launches = expect_launches("predict(save_txt, save_crop) over the photos",
                                   {"decode_box_best": -(-n // P12_PREDICT_BATCH), "decode_xywh": 0,
                                    "int8_matmul": 0})
    if plain_calls:
        raise SystemExit(f"phase 12 predict ran the decode's plain version {len(plain_calls)} times on the card")
    print(f"phase 12d predict(save_txt, save_crop) of the {n} photos: {wall * 1e3:.1f} ms (host clock)")
    want = host.predict(source, **args)
    check_finite("photo predictions", [r.boxes.data for r in got])
    compare_with_cpu("predict from JPEG files", [r.boxes.data for r in got], [r.boxes.data for r in want])
    labels = sorted((root / "pred" / "labels").glob("*.txt"))
    crops = sorted((root / "pred" / "crops").rglob("*.jpg"))
    n_crops = sum(sum(int(min(r.orig_shape[1], b[2])) > int(max(0, b[0])) and
                      int(min(r.orig_shape[0], b[3])) > int(max(0, b[1])) for b in r.boxes.data) for r in got)
    rows = sum(len(f.read_text().splitlines()) for f in labels)
    bad = [c for c in crops[:50] if imread(c) is None or imread(c).size == 0]
    print(f"  file outputs: {len(labels)} label files ({rows} rows for {sum(len(r) for r in got)} detections), "
          f"{len(crops)} crops (expected {n_crops}), the first {min(50, len(crops))} decode")
    if len(labels) != n or rows != sum(len(r) for r in got) or len(crops) != n_crops or bad:
        raise SystemExit("predict(save_txt, save_crop) wrote other files than its detections")
    rate = photo_rate(card, root, args)
    t0 = time.perf_counter()
    vec = card.embed(source, imgsz=IMGSZ)
    embed_ms = (time.perf_counter() - t0) * 1e3 / n
    ref = host.embed(source, imgsz=IMGSZ)
    err = max(float(np.linalg.norm(a - b) / np.linalg.norm(b)) for a, b in zip(vec, ref))
    print(f"phase 12d embed: {len(vec)} vectors of {vec[0].size} values, {embed_ms:.2f} ms per photo (host clock); "
          f"card vs CPU norm-relative difference at most {err:.3g} (tol {EMBED_RTOL})")
    if len(vec) != n or err > EMBED_RTOL or not all(np.isfinite(v).all() for v in vec):
        raise SystemExit("embed on the card differs from the CPU's")
    return {k: launches[k] + rate[k] for k in launches}


def photo_path(dev):
    """Phase 12: real photos (module docstring)."""
    codec_checks()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p12_") as d:
        t0 = time.perf_counter()
        trained = photo_train_val(dev, Path(d))
        print(f"  phase 12c in {time.perf_counter() - t0:.1f} s")
        predicted = photo_predict(dev, Path(d))
    return {k: trained[k] + predicted[k] for k in trained}


# phase 13: the Segment and Pose task heads (yolo11n-seg at nc 80, yolo11n-pose at nc 1 with 17 x 3 keypoints)
P13_TRAIN, P13_VAL, P13_HW = 32, 8, (480, 640)
P13_BATCH, P13_WORKERS, P13_STEP_BATCH = 8, 2, 2
# card vs CPU predict. The task graphs with draw_weights give logits packed within 1e-5 of each other (on the
# CPU, yolo11n-seg's 361 best candidates of a frame, one class on the stride-32 level, span 4.020 to 4.073, with
# duplicates): which of them NMS keeps is decided by float rounding, and cuDNN's rounds otherwise than the CPU's
# (0.942 and 0.908 of the rows paired, conf 0.25 and 0.98, NVIDIA H100 80GB HBM3, 700 W; the matched rows within
# 1.5e-4 px). So the graph is held on its head maps (as phase 3 holds them), and the path after it (the decode
# kernel, NMS, the masks and keypoints) on the card's own head maps replayed through the CPU's predictor; the
# rows of the CPU's own graph are paired and printed beside it.
P13_HEAD_RTOL = 1e-4  # head maps and prototypes, card vs CPU, of their largest magnitude (phase 3's gate)
P13_CONF = 0.25  # a served threshold
P13_MASK_IOU = 0.99  # mean mask IoU of the paired rows, card vs CPU
P13_KPT_PX = 0.05  # keypoints of the paired rows, card vs CPU
P13_LOSS_RTOL = 1e-3  # one train step's loss items, card vs CPU (the mask and keypoint terms sum more terms)
TASKS = (("segment", "yolo11n-seg.yaml", 80), ("pose", "yolo11n-pose.yaml", 1))
COCO_FLIP_IDX = [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15]


def task_graph(yaml: str, nc: int, dev, seed: int, drawn: bool = True):
    """The task graph at full width with ``nc`` classes on ``dev``, weights from ``draw_weights`` (``drawn``)
    or the seeded init that training starts from."""
    from bsyolo_tpu_torch.cfg import model_yaml_path
    from bsyolo_tpu_torch.nn.model import build_model
    from bsyolo_tpu_torch.nn.parser import load_model_yaml, parse_model_yaml

    d = load_model_yaml(model_yaml_path(yaml))
    d["nc"] = nc
    graph = build_model(parse_model_yaml(d, scale=d.get("scale", "")), "cpu", seed)
    if drawn:
        draw_weights(graph, seed)
    return graph.to(dev)


def check_decode_task_heads(dev):
    """Phase 2: decode_box on the Segment head (64 + 80 + 32 channels) and the Pose head (64 + 1 + 51) of
    a real forward at 640 px, batch 4, float32 and bfloat16 (the bf16 graph's head, phase 15's), against its
    plain version; the kernel's time beside its bound."""
    import torch

    from bsyolo_tpu_torch.kernels.decode import REG_MAX, box_best_cuda, box_best_reference
    from bsyolo_tpu_torch.nn.model import set_compute_dtype

    x = torch.from_numpy(np.random.default_rng(SEED + 13).integers(0, 256, (4, 3, IMGSZ, IMGSZ), dtype=np.uint8))
    x = x.to(dev).float() / 255.0
    rows = {}
    for (task, yaml, nc), dtype in itertools.product(TASKS, (torch.float32, torch.bfloat16)):
        graph = set_compute_dtype(task_graph(yaml, nc, dev, SEED + 13), dtype)
        with torch.inference_mode():
            out = graph(x)
        feats = out["feats"] if task == "segment" else out
        key = task if dtype == torch.float32 else f"{task} bf16"
        strides, b, no = graph.spec.head_strides, feats[0].shape[0], feats[0].shape[1]
        a = sum(f.shape[2] * f.shape[3] for f in feats)
        boxes, best, cls = box_best_cuda(feats, strides, nc)
        want_boxes, want_best, want_cls = box_best_reference(feats, strides, nc)
        torch.cuda.synchronize()
        err = (boxes - want_boxes).abs().max().item()
        best_err = (best - want_best).abs().max().item()
        cls_equal = torch.equal(cls, want_cls)
        ok = bool(torch.isfinite(boxes).all()) and err <= BOX_ATOL_PX and best_err == 0.0 and cls_equal
        print(f"decode_box_best on the {key} head of a real forward: B={b} A={a} nc={nc}, {no} channels per "
              f"anchor ({no - 4 * REG_MAX - nc} past the class logits): max|box err| {err:.3g} px (tol "
              f"{BOX_ATOL_PX}), max|best err| {best_err:.3g} (tol 0), class logits equal {cls_equal}; "
              f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"decode_box_best disagrees with its plain version on the {task} head")
        # the channels it reads (2 bytes each on a bf16 head), its float32 outputs
        bytes_moved = b * a * (4 * REG_MAX + nc) * feats[0].element_size() + b * a * (4 + 1 + nc) * 4
        ops = b * a * (4 * (6 * REG_MAX + 1) + nc + 8)
        rows[key] = dict(channels=no, max_abs_err=err, **time_against_plain(
            f"{key} head B4 640", box_best_cuda, box_best_reference, (feats, strides, nc), bytes_moved, ops))
        del graph, out, feats
        torch.cuda.empty_cache()
    return rows


def write_task_jpeg_dataset(root, task: str, nc: int, seed: int):
    """P13_TRAIN + P13_VAL seeded 480x640 JPEG frames (the port's encoder, quality 95), 1 to 4 instances
    each: filled convex polygons of 8 to 16 vertices, one colour per class (segment rows ``cls x1 y1 ...``),
    or boxes with 17 keypoints inside, each drawn as a dot, about a fifth of them invisible (pose rows
    ``cls cx cy w h kx ky v ...``); returns the dataset YAML's path."""
    from bsyolo_tpu_torch.data.cv import fill_poly
    from bsyolo_tpu_torch.data.imread import imwrite

    rng = np.random.default_rng(seed)
    colours = rng.integers(40, 256, (nc, 3))
    h, w = P13_HW
    for split, n in (("train", P13_TRAIN), ("val", P13_VAL)):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
        for i in range(n):
            img = rng.integers(0, 40, (h, w, 3), dtype=np.uint8)
            rows = []
            for _ in range(int(rng.integers(1, 5))):
                c = int(rng.integers(0, nc))
                cx, cy = rng.uniform(0.2, 0.8) * w, rng.uniform(0.2, 0.8) * h
                rx, ry = rng.uniform(w / 20, w / 6), rng.uniform(h / 20, h / 6)
                if task == "segment":
                    ang = np.sort(rng.uniform(0, 2 * np.pi, int(rng.integers(8, 17))))
                    poly = np.stack([cx + rx * np.cos(ang), cy + ry * np.sin(ang)], -1)
                    mask = fill_poly(np.zeros((h, w), np.uint8), [np.round(poly).astype(np.int32)], 1)
                    img[mask > 0] = colours[c]
                    rows.append(f"{c} " + " ".join(f"{x / w:.6f} {y / h:.6f}" for x, y in poly))
                else:
                    x0, y0, x1, y1 = cx - rx, cy - ry, cx + rx, cy + ry
                    img[int(y0) : int(y1), int(x0) : int(x1)] = colours[c]
                    k = np.stack([rng.uniform(x0, x1, 17), rng.uniform(y0, y1, 17),
                                  np.where(rng.uniform(0, 1, 17) < 0.8, 2.0, 0.0)], -1)
                    for kx, ky, v in k:
                        if v:
                            img[int(ky) - 2 : int(ky) + 3, int(kx) - 2 : int(kx) + 3] = 255
                    rows.append(f"{c} {cx / w:.6f} {cy / h:.6f} {2 * rx / w:.6f} {2 * ry / h:.6f} "
                                + " ".join(f"{kx / w:.6f} {ky / h:.6f} {v:.0f}" for kx, ky, v in k))
            imwrite(root / "images" / split / f"{i:04d}.jpg", img)
            (root / "labels" / split / f"{i:04d}.txt").write_text("\n".join(rows) + "\n")
    extra = f"kpt_shape: [17, 3]\nflip_idx: {COCO_FLIP_IDX}\n" if task == "pose" else ""
    yaml = root / "data.yaml"
    yaml.write_text(f"path: {root}\ntrain: images/train\nval: images/val\n{extra}names:\n"
                    + "".join(f"  {i}: {'person' if task == 'pose' else f'class{i}'}\n" for i in range(nc)))
    return yaml


def task_step_against_cpu(dev, task, yaml, nc, data):
    """Phase 13a: one train step at batch 2 from the same drawn weights and loader batch, card against CPU."""
    import torch

    from bsyolo_tpu_torch.cfg import DEFAULT_CFG_DICT
    from bsyolo_tpu_torch.data import DataLoader, YOLODataset, load_dataset_yaml
    from bsyolo_tpu_torch.engine.train_step import init_train_state, make_train_step, task_criterion
    from bsyolo_tpu_torch.engine.trainer import to_device

    d = load_dataset_yaml(str(data))
    ds = YOLODataset(d["train"], imgsz=IMGSZ, augment=True, hyp=dict(DEFAULT_CFG_DICT), task=task,
                     flip_idx=d.get("flip_idx"))
    batch = next(iter(DataLoader(ds, P13_STEP_BATCH, shuffle=True, seed=3)))
    host_graph = task_graph(yaml, nc, "cpu", SEED + 14)
    results = {}
    for where, graph in (("cpu", host_graph), ("card", copy.deepcopy(host_graph).to(dev))):
        cfg = train_config(graph.spec, P13_STEP_BATCH)
        criterion, names = task_criterion(graph.spec)
        on = torch.device(dev) if where == "card" else torch.device("cpu")
        t0 = time.perf_counter()
        state, metrics = make_train_step(graph, cfg, criterion, names)(init_train_state(graph, cfg),
                                                                         to_device(batch, on))
        items = np.array([float(metrics[k]) for k in names])
        results[where] = (items, {n: p.detach().cpu() for n, p in state.params.items()}, time.perf_counter() - t0)
    (gi, gp, gs), (wi, wp, ws) = results["card"], results["cpu"]
    rel = np.abs(gi - wi) / np.maximum(np.abs(wi), 1e-30)
    param = max(_rel_max(gp[n], wp[n]) for n in wp)
    print(f"phase 13a {task} train step, batch {P13_STEP_BATCH} at {IMGSZ}, card vs CPU: loss items {names} "
          f"{gi.tolist()} vs {wi.tolist()}, rel diff {rel.tolist()} (tol {P13_LOSS_RTOL}); params after the step, "
          f"max |diff| over the tensor's max |value| {param:.3g}; card {gs:.2f} s, CPU {ws:.2f} s")
    if not (np.isfinite(gi).all() and (rel <= P13_LOSS_RTOL).all()):
        raise SystemExit(f"the {task} train step's loss items on the card differ from the CPU's")


def mask_iou(a: np.ndarray, b: np.ndarray) -> float:
    union = np.logical_or(a > 0.5, b > 0.5).sum()
    return float(np.logical_and(a > 0.5, b > 0.5).sum() / union) if union else 1.0


class Replay:
    """Stands in for a graph: returns recorded outputs, in order, whatever it is given (and keeps what it
    was given)."""

    def __init__(self, outputs):
        self.outputs, self.inputs = list(outputs), []

    def __call__(self, x):
        self.inputs.append(x)
        return self.outputs.pop(0)

    training = False

    def modules(self):
        return iter(())

    def train(self, mode: bool = True):
        return self

    def eval(self):
        return self


def _to(out, dev):
    return {k: _to(v, dev) for k, v in out.items()} if isinstance(out, dict) else (
        [t.to(dev) for t in out] if isinstance(out, list) else out.to(dev))


def _paired_payloads(task, got, want):
    """(mean mask IoU, min) or (max |keypoint xy diff|, max |visibility diff|) over the rows match_pairs pairs."""
    ious, kpt, vis = [], 0.0, 0.0
    for g, w in zip(got, want):
        for gi, wi, _, _ in match_pairs(g.boxes.data, w.boxes.data):
            if task == "segment":
                ious.append(mask_iou(g.masks.data[gi], w.masks.data[wi]))
            else:
                kpt = max(kpt, float(np.abs(g.keypoints.data[gi, :, :2] - w.keypoints.data[wi, :, :2]).max()))
                vis = max(vis, float(np.abs(g.keypoints.data[gi, :, 2] - w.keypoints.data[wi, :, 2]).max()))
    if task == "segment":
        return (float(np.mean(ious)) if ious else 0.0), (min(ious) if ious else 0.0)
    return kpt, vis


def task_predict_against_cpu(dev, task, best, frames):
    """Phase 13c: YOLO(best.ckpt) with drawn weights on the card, at batch 4 and conf 0.25 (segment with and
    without retina_masks): the head maps and prototypes against the CPU graph's, the rows, masks and keypoints
    against the CPU's predictor run on the card's head maps (see P13_HEAD_RTOL), and, printed, against the CPU's
    own graph; ms per batch of 4 and process_mask's device time."""
    import torch

    from bsyolo_tpu_torch import YOLO
    from bsyolo_tpu_torch.ops.letterbox import letterbox
    from bsyolo_tpu_torch.ops.masks import process_mask

    host, card = YOLO(best, device="cpu"), YOLO(best)
    draw_weights(host.model, SEED + 15)
    card.model.load_state_dict(host.model.state_dict())
    x = torch.stack([letterbox(f, (IMGSZ, IMGSZ), "cpu") for f in frames[:4]]).float() / 255.0
    with torch.inference_mode():
        want_head, got_head = host.model(x), _to(card.model(x.to(dev)), "cpu")
    pairs = [("feats", w, g) for w, g in zip(want_head["feats"] if task == "segment" else want_head,
                                            got_head["feats"] if task == "segment" else got_head)]
    if task == "segment":
        pairs.append(("proto", want_head["proto"], got_head["proto"]))
    for name, w, g in pairs:
        err, scale = (g - w).abs().max().item(), w.abs().max().item()
        print(f"  {task} {name} {tuple(w.shape[1:])} card vs CPU: max|err| {err:.3g} at max|value| {scale:.3g}")
        if not err <= P13_HEAD_RTOL * scale:
            raise SystemExit(f"{task} head on the card disagrees with the CPU beyond {P13_HEAD_RTOL} of its scale")
    out = {}
    for kw in ({}, {"retina_masks": True}) if task == "segment" else ({},):
        card.predict(frames[:4], imgsz=IMGSZ, batch=4, conf=P13_CONF, **kw)  # warm-up
        recorded, inputs = [], []

        def record(module, args, output):  # returns None: the output passes on unchanged
            inputs.append(args[0].cpu())
            recorded.append(_to(output, "cpu"))

        hook = card.model.register_forward_hook(record)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            got = card.predict(frames, imgsz=IMGSZ, batch=4, conf=P13_CONF, **kw)
            torch.cuda.synchronize()
        finally:
            hook.remove()
        ms = (time.perf_counter() - t0) * 1e3 / math.ceil(len(frames) / 4)
        replay = YOLO(best, device="cpu")
        replay.model = Replay(recorded)
        want = replay.predict(frames, imgsz=IMGSZ, batch=4, conf=P13_CONF, **kw)
        # the uint8 letterboxed batches (the graph's input is x / 255, which the card divides otherwise)
        if not all(torch.equal((a * 255).round(), (b * 255).round()) for a, b in zip(inputs, replay.model.inputs)):
            raise SystemExit(f"{task}: the card's letterboxed batches differ from the CPU's")
        label = f"{task} predict{' retina_masks' if kw else ''}"
        frac = compare_with_cpu(f"{label}, the CPU's path on the card's head maps", [r.boxes.data for r in got],
                                [r.boxes.data for r in want])
        first, second = _paired_payloads(task, got, want)
        own = host.predict(frames, imgsz=IMGSZ, batch=4, conf=P13_CONF, **kw)
        own_frac = len([1 for g, w in zip(got, own) for _ in match_pairs(g.boxes.data, w.boxes.data)]) / max(
            sum(len(r) for r in own), sum(len(r) for r in got), 1)
        own_first, _ = _paired_payloads(task, got, own)
        rows = sum(len(r) for r in got)
        if task == "segment":
            print(f"  {label}: {ms:.1f} ms per batch of 4 on the card (host clock, letterbox to masks at the frame's "
                  f"size), {rows} rows; mean mask IoU of the paired rows {first:.5f} (min {second:.5f}; tol "
                  f"{P13_MASK_IOU}); against the CPU's own graph: {own_frac:.4f} of the rows paired, mean mask IoU "
                  f"{own_first:.5f} (printed)")
            if first < P13_MASK_IOU:
                raise SystemExit(f"{label}: masks on the card differ from the CPU's (mean IoU {first})")
        else:
            print(f"  {label}: {ms:.1f} ms per batch of 4 on the card (host clock), {rows} rows; keypoints of the "
                  f"paired rows max |xy diff| {first:.3g} px (tol {P13_KPT_PX}), max |visibility diff| {second:.3g}; "
                  f"against the CPU's own graph: {own_frac:.4f} of the rows paired, keypoints within {own_first:.3g} "
                  "px (printed)")
            if first > P13_KPT_PX:
                raise SystemExit(f"{label}: keypoints on the card differ from the CPU's by {first} px")
        out[label] = {"ms_per_batch": ms, "paired": frac, "paired_own_graph": own_frac, "rows": rows}
    if task == "segment":  # process_mask alone, at one frame's kept rows
        dets, coeffs, proto = card.predictor.forward(torch.stack([letterbox(frames[0], (IMGSZ, IMGSZ), dev)]))
        keep = dets[0, :, 4] > 0
        n = int(keep.sum())
        args = (proto[0], coeffs[0][keep], dets[0][keep][:, :4], (IMGSZ, IMGSZ))
        call_ms, dev_ms = cuda_time_ms(process_mask, [args], 20)
        print(f"  process_mask at {n} kept rows, prototypes {tuple(proto.shape[1:])} -> {n} masks at {IMGSZ}x{IMGSZ}: "
              f"{dev_ms * 1e3:.1f} us on the device, {call_ms * 1e3:.1f} us per call (events)")
        out["process_mask"] = {"rows": n, "device_ms": dev_ms, "call_ms": call_ms}
    return out


def task_path(dev, root):
    """Phase 13: for yolo11n-seg (nc 80) and yolo11n-pose (nc 1, 17 x 3 keypoints) at full width: a seeded
    JPEG dataset; (a) one train step card vs CPU; (b) YOLO.train 2 epochs at batch 8, YOLO(best.ckpt).val
    and .predict (segment: with and without retina_masks), one decode_box launch per validation and
    predict batch, no plain decode; (c) card vs CPU predict on drawn weights. Returns the launches."""
    import torch

    from bsyolo_tpu_torch import YOLO, kernels
    from bsyolo_tpu_torch.data.imread import imread

    total = {"decode_box_best": 0, "decode_xywh": 0, "int8_matmul": 0}
    for task, yaml, nc in TASKS:
        t0 = time.perf_counter()
        data = write_task_jpeg_dataset(Path(root) / task, task, nc, SEED + 30)
        frames = [imread(p) for p in sorted((Path(root) / task / "images" / "val").glob("*.jpg"))]
        print(f"phase 13 {task} dataset: {P13_TRAIN} train + {P13_VAL} val JPEG frames {P13_HW[0]}x{P13_HW[1]}, "
              f"{nc} classes, written in {time.perf_counter() - t0:.2f} s")
        task_step_against_cpu(dev, task, yaml, nc, data)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        with plain_decode_calls() as plain_calls:
            kernels.reset_launch_counts()
            model = YOLO(yaml)
            t1 = time.perf_counter()
            model.train(data=str(data), epochs=2, close_mosaic=1, imgsz=IMGSZ, batch=P13_BATCH, amp=False,
                        plots=False, workers=P13_WORKERS, seed=3, project=str(Path(root) / "runs"), name=task,
                        exist_ok=True)
            train_s = time.perf_counter() - t1
            best = Path(root) / "runs" / task / "weights" / "best.ckpt"
            loaded = YOLO(best)
            if loaded.task != task or loaded.spec.nc != nc:
                raise SystemExit(f"YOLO(best.ckpt) rebuilt a {loaded.task} graph with nc {loaded.spec.nc}")
            t2 = time.perf_counter()
            metrics = loaded.val(data=str(data), batch=P13_BATCH)
            torch.cuda.synchronize()
            val_s = time.perf_counter() - t2
            results = [loaded.predict(frames, imgsz=IMGSZ, batch=4, conf=CONF, **kw)
                       for kw in (({}, {"retina_masks": True}) if task == "segment" else ({},))]
            torch.cuda.synchronize()
            n_val = -(-P13_VAL // P13_BATCH)
            expected = {"decode_box_best": 2 * n_val + n_val + len(results) * -(-len(frames) // 4), "decode_xywh": 0,
                        "int8_matmul": 0}
            launches = expect_launches(f"{task} trainer and facade", expected)
        if plain_calls:
            raise SystemExit(f"phase 13 ran the decode's plain version {len(plain_calls)} times on the card")
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        for e, (wait, wall, n) in enumerate(model.trainer.loader_wait):
            print(f"  {task} epoch {e}: {n} steps in {wall:.2f} s, {wall * 1e3 / n:.1f} ms per step (host clock, "
                  f"loader in the loop, {P13_WORKERS} workers), loader-wait share {wait / wall:.3f}"
                  + (", the pool starts" if e == 0 else ""))
        print(f"phase 13b {task}: YOLO.train 2 epochs in {train_s:.1f} s, peak memory allocated {peak_gb:.2f} GB; "
              f"val {val_s * 1e3 / P13_VAL:.2f} ms per image: "
              f"{', '.join(f'{k} {float(v):.4f}' for k, v in metrics.results_dict.items())}; predict "
              f"{[sum(len(r) for r in res) for res in results]} rows over {len(frames)} frames")
        for res in results:
            payload = [r.masks if task == "segment" else r.keypoints for r in res]
            if any(len(r) and (p is None or len(p) != len(r)) for p, r in zip(payload, res)):
                raise SystemExit(f"{task} results lack their masks or keypoints")
            if not all(np.isfinite(r.boxes.data).all() for r in res):  # 2 epochs from the default init: few rows
                raise SystemExit(f"{task} predict through best.ckpt gave rows that are not finite")
        kernels.reset_launch_counts()
        task_predict_against_cpu(dev, task, best, frames)
        launches = {k: launches[k] + v for k, v in expect_launches(
            f"{task} card vs CPU predict", {"decode_box_best": (2 if task == "segment" else 1) * 3 + (
                1 if task == "segment" else 0), "decode_xywh": 0, "int8_matmul": 0}).items()}
        total = {k: total[k] + launches[k] for k in total}
    return total


# phase 14: the OBB and Classify task families (yolo11n-obb at nc 15 and 1024 px, yolo11n-cls at nc 10 and 224 px)
P14_OBB_TRAIN, P14_OBB_VAL, P14_OBB_SIDE, P14_OBB_BATCH, P14_OBB_STEP_BATCH = 32, 8, 1024, 4, 2
P14_CLS_NC, P14_CLS_TRAIN, P14_CLS_VAL, P14_CLS_HW, P14_CLS_IMGSZ = 10, 16, 4, (256, 320), 224
P14_CLS_BATCH, P14_CLS_STEP_BATCH, P14_WORKERS = 32, 8, 2
P14_ANGLE_RAD = 1e-5  # paired rotated rows, card vs CPU postprocess on the same head maps
P14_BOX_PX = 1e-3
P14_PROB_ATOL = 1e-5  # class probabilities, card vs CPU
NO_LAUNCHES = {"decode_box_best": 0, "decode_xywh": 0, "int8_matmul": 0}


def write_obb_jpeg_dataset(root, names, seed: int):
    """P14_OBB_TRAIN + P14_OBB_VAL seeded square JPEG frames of P14_OBB_SIDE px (the port's encoder), 2 to 12
    rotated rectangles each, 16 to 240 px long, one colour per class, labelled as DOTA-style corner rows
    ``cls x1 y1 ... x4 y4`` (normalized); returns the dataset YAML's path."""
    from bsyolo_tpu_torch.data.cv import fill_poly
    from bsyolo_tpu_torch.data.imread import imwrite

    rng = np.random.default_rng(seed)
    colours = rng.integers(40, 256, (len(names), 3))
    side = P14_OBB_SIDE
    for split, n in (("train", P14_OBB_TRAIN), ("val", P14_OBB_VAL)):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
        for i in range(n):
            img = rng.integers(0, 40, (side, side, 3), dtype=np.uint8)
            rows = []
            for _ in range(int(rng.integers(2, 13))):
                c = int(rng.integers(0, len(names)))
                w, h, r = rng.uniform(16, 240), rng.uniform(8, 80), rng.uniform(-np.pi / 2, np.pi / 2)
                cx, cy = rng.uniform(0.1, 0.9, 2) * side
                d = np.array([[w / 2, h / 2], [-w / 2, h / 2], [-w / 2, -h / 2], [w / 2, -h / 2]])
                pts = (d @ np.array([[np.cos(r), np.sin(r)], [-np.sin(r), np.cos(r)]]) + [cx, cy]).clip(0, side - 1)
                img[fill_poly(np.zeros((side, side), np.uint8), [np.round(pts).astype(np.int32)], 1) > 0] = colours[c]
                rows.append(f"{c} " + " ".join(f"{v / side:.6f}" for v in pts.reshape(-1)))
            imwrite(root / "images" / split / f"{i:04d}.jpg", img)
            (root / "labels" / split / f"{i:04d}.txt").write_text("\n".join(rows) + "\n")
    yaml = root / "data.yaml"
    yaml.write_text(f"path: {root}\ntrain: images/train\nval: images/val\nnames:\n"
                    + "".join(f"  {i}: {n}\n" for i, n in enumerate(names)))
    return yaml


def write_cls_jpeg_dataset(root, seed: int):
    """A folder-per-class set: P14_CLS_NC classes x (P14_CLS_TRAIN train + P14_CLS_VAL val) seeded JPEG frames
    of P14_CLS_HW, each class a shape of its own colour and size on noise; returns the root."""
    from bsyolo_tpu_torch.data.imread import imwrite

    rng = np.random.default_rng(seed)
    h, w = P14_CLS_HW
    for split, n in (("train", P14_CLS_TRAIN), ("val", P14_CLS_VAL)):
        for c in range(P14_CLS_NC):
            d = root / split / f"class{c}"
            d.mkdir(parents=True)
            colour = np.random.default_rng(c).integers(40, 256, 3)
            for i in range(n):
                img = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
                s = 20 + 12 * c
                y, x = int(rng.integers(0, h - s)), int(rng.integers(0, w - s))
                img[y : y + s, x : x + s] = colour
                imwrite(d / f"{i:03d}.jpg", img)
    return root


def obb_pairs(got: np.ndarray, want: np.ndarray):
    """[(i, j, max |xywh diff|, |angle diff|)]: each rotated row of ``got`` paired with an unused row of
    ``want`` of its class within P14_BOX_PX, P14_ANGLE_RAD and MATCH_SCORE."""
    used, out = set(), []
    for i, g in enumerate(got):
        for j, w in enumerate(want):
            if j in used or g[5] != w[5] or abs(g[4] - w[4]) > MATCH_SCORE:
                continue
            box, ang = float(np.abs(g[:4] - w[:4]).max()), float(abs(g[6] - w[6]))
            if box <= P14_BOX_PX and ang <= P14_ANGLE_RAD:
                used.add(j)
                out.append((i, j, box, ang))
                break
    return out


def one_step(graph, batch, on, dtype=None):
    """One train step from ``graph``'s weights on ``batch`` on the device ``on``, in ``dtype`` (None: the graph's
    own, float32; bfloat16: the amp step over float32 weights); returns (the loss items, the item names, the
    parameters after the step on the CPU, the seconds, the head outputs' dtypes, whether the parameters, EMA and
    BatchNorm statistics stayed float32)."""
    import torch

    from bsyolo_tpu_torch.engine.train_step import init_train_state, make_train_step, task_criterion
    from bsyolo_tpu_torch.engine.trainer import to_device
    from bsyolo_tpu_torch.nn.model import set_compute_dtype

    g, heads = copy.deepcopy(graph).to(on), []
    if dtype is not None:
        set_compute_dtype(g, dtype)
        g.model[-1].register_forward_hook(lambda m, a, out: heads.append(
            (out["proto"] if isinstance(out, dict) else out if torch.is_tensor(out) else out[0]).dtype))
    cfg = train_config(g.spec, len(batch["cls"]))
    criterion, names = task_criterion(g.spec)
    t0 = time.perf_counter()
    state, metrics = make_train_step(g, cfg, criterion, names)(init_train_state(g, cfg), to_device(batch, on))
    items = np.array([float(metrics[k]) for k in names])
    float_state = all(t.dtype == torch.float32 for t in (*state.params.values(), *state.ema_params.values(),
                                                           *state.batch_stats.values()))
    return (items, names, {n: p.detach().cpu() for n, p in state.params.items()}, time.perf_counter() - t0, heads,
            float_state)


def step_against_cpu(dev, task, graph, batch, label, dtype=None, tol: float = P13_LOSS_RTOL):
    """One train step from ``graph``'s weights on ``batch``, on the CPU and on the card, in ``dtype`` (None: the
    graph's own, float32; bfloat16: the amp step over float32 weights, whose heads, parameters, EMA and BatchNorm
    statistics are checked too): the loss items card vs CPU within ``tol``. Phases 14a and 15a."""
    import torch

    results = {where: one_step(graph, batch, torch.device(on), dtype) for where, on in (("cpu", "cpu"),
                                                                                         ("card", dev))}
    names = results["cpu"][1]
    results = {k: (v[0], *v[2:]) for k, v in results.items()}
    (gi, gp, gs, gh, gf), (wi, wp, ws, wh, wf) = results["card"], results["cpu"]
    rel = np.abs(gi - wi) / np.maximum(np.abs(wi), 1e-30)
    param = max(_rel_max(gp[n], wp[n]) for n in wp)
    print(f"{label}, card vs CPU: loss items {names} {gi.tolist()} vs {wi.tolist()}, rel diff {rel.tolist()} (tol "
          f"{tol}); params after the step, max |diff| over the tensor's max |value| {param:.3g}; "
          + (f"head out {gh} / {wh}; " if dtype is not None else "") + f"card {gs:.2f} s, CPU {ws:.2f} s")
    if not (np.isfinite(gi).all() and (rel <= tol).all() and gf and wf):
        raise SystemExit(f"the {task} train step's loss items on the card differ from the CPU's")
    if dtype is not None and not gh == wh == [dtype]:
        raise SystemExit(f"the {task} {dtype} graph's head gave {gh} on the card, {wh} on the CPU")


def obb_predict_against_cpu(dev, best, frames):
    """Phase 14c (OBB): YOLO(best.ckpt) with drawn weights on the card at batch 4 and conf 0.25: the head maps
    against the CPU graph's, the rotated rows against the CPU's postprocess run on the card's head maps (a
    Replay of them), and, printed, against the CPU's own graph; ms per batch of 4."""
    import torch

    from bsyolo_tpu_torch import YOLO
    from bsyolo_tpu_torch.ops.letterbox import letterbox

    host, card = YOLO(best, device="cpu"), YOLO(best)
    draw_weights(host.model, SEED + 41)
    card.model.load_state_dict(host.model.state_dict())
    side = P14_OBB_SIDE
    x = torch.stack([letterbox(f, (side, side), "cpu") for f in frames[:4]]).float() / 255.0
    with torch.inference_mode():
        want_head, got_head = host.model(x), _to(card.model(x.to(dev)), "cpu")
    for w, g in zip(want_head, got_head):
        err, scale = (g - w).abs().max().item(), w.abs().max().item()
        print(f"  obb head level {tuple(w.shape[1:])} card vs CPU: max|err| {err:.3g} at max|value| {scale:.3g}")
        if not err <= P13_HEAD_RTOL * scale:
            raise SystemExit(f"the OBB head on the card disagrees with the CPU beyond {P13_HEAD_RTOL} of its scale")
    card.predict(frames[:4], imgsz=side, batch=4, conf=P13_CONF)  # warm-up
    recorded = []
    hook = card.model.register_forward_hook(lambda module, args, output: recorded.append(_to(output, "cpu")))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        got = card.predict(frames, imgsz=side, batch=4, conf=P13_CONF)
        torch.cuda.synchronize()
    finally:
        hook.remove()
    ms = (time.perf_counter() - t0) * 1e3 / math.ceil(len(frames) / 4)
    replay = YOLO(best, device="cpu")
    replay.model = Replay(recorded)
    want = replay.predict(frames, imgsz=side, batch=4, conf=P13_CONF)
    pairs = [obb_pairs(g.obb.data, w.obb.data) for g, w in zip(got, want)]
    rows, want_rows = sum(len(r) for r in got), sum(len(r) for r in want)
    frac = sum(len(p) for p in pairs) / max(rows, want_rows, 1)
    box = max((b for p in pairs for _, _, b, _ in p), default=0.0)
    ang = max((a for p in pairs for _, _, _, a in p), default=0.0)
    own = host.predict(frames, imgsz=side, batch=4, conf=P13_CONF)
    own_frac = sum(len(obb_pairs(g.obb.data, w.obb.data)) for g, w in zip(got, own)) / max(
        rows, sum(len(r) for r in own), 1)
    print(f"  obb predict: {ms:.1f} ms per batch of 4 on the card (host clock, letterbox to rotated rows at the "
          f"frame's size), {rows} rows; against the CPU's postprocess on the card's head maps: {frac:.4f} of the rows "
          f"paired (tol {MATCH_MIN_FRACTION}), max |xywh diff| {box:.3g} px, max |angle diff| {ang:.3g} rad; against "
          f"the CPU's own graph: {own_frac:.4f} paired (printed)")
    if not (rows and all(np.isfinite(r.obb.data).all() for r in got)):
        raise SystemExit("obb predict on drawn weights gave no rows, or rows that are not finite")
    if frac < MATCH_MIN_FRACTION:
        raise SystemExit(f"obb predict on the card pairs only {frac:.4f} of the CPU's rows")
    return {"ms_per_batch": ms, "paired": frac, "paired_own_graph": own_frac, "rows": rows}


def cls_predict_against_cpu(dev, frames, root):
    """Phase 14c (classify): yolo11n-cls at nc 1000 with drawn weights, batch 4: top 5 and probabilities
    against the CPU's; ms per batch of 4."""
    import torch

    from bsyolo_tpu_torch import YOLO
    from bsyolo_tpu_torch.cfg import model_yaml_path

    text = model_yaml_path("yolo11-cls.yaml").read_text()
    name = str(root / "yolo11n-cls-imagenet.yaml")  # yolo11-cls.yaml at scale n with ImageNet's 1000 classes
    Path(name).write_text(text.replace("\nnc: 80\n", "\nnc: 1000\nscale: n\n"))
    host, card = YOLO(name, device="cpu"), YOLO(name)
    if card.spec.nc != 1000:
        raise SystemExit(f"the nc 1000 classify graph has nc {card.spec.nc}")
    draw_weights(host.model, SEED + 42)
    card.model.load_state_dict(host.model.state_dict())
    card.predict(frames[:4], imgsz=P14_CLS_IMGSZ, batch=4)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = card.predict(frames, imgsz=P14_CLS_IMGSZ, batch=4)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / math.ceil(len(frames) / 4)
    want = host.predict(frames, imgsz=P14_CLS_IMGSZ, batch=4)
    top5 = all(g.probs.top5 == w.probs.top5 for g, w in zip(got, want))
    err = max(float(np.abs(g.probs.data - w.probs.data).max()) for g, w in zip(got, want))
    spread = float(np.mean([g.probs.top1conf for g in got]))
    print(f"  classify predict (nc 1000): {ms:.1f} ms per batch of 4 on the card (host clock, letterbox to "
          f"probabilities), {len(got)} frames; top 5 equal to the CPU's {top5}, max |prob diff| {err:.3g} (tol "
          f"{P14_PROB_ATOL}); mean top-1 probability {spread:.4f}")
    if not (top5 and err <= P14_PROB_ATOL):
        raise SystemExit("classify predict on the card differs from the CPU's")
    return {"ms_per_batch": ms, "max_prob_diff": err}


def obb_classify_path(dev, root):
    """Phase 14: yolo11n-obb (nc 15, 1024 px) and yolo11n-cls (nc 10, 224 px) at full width: seeded JPEG sets;
    (a) one train step card vs CPU; (b) YOLO.train 2 epochs with 2 workers, YOLO(best.ckpt).val and .predict;
    (c) card vs CPU predict on drawn weights (classify at nc 1000). No kernel of the port is on these paths:
    every launch counter stays 0. Returns the launches."""
    import torch

    from bsyolo_tpu_torch import YOLO, kernels
    from bsyolo_tpu_torch.cfg import DEFAULT_CFG_DICT, read_yaml
    from bsyolo_tpu_torch.data import DataLoader, YOLODataset, load_dataset_yaml
    from bsyolo_tpu_torch.data.classify import ClassificationDataset, ClassifyLoader
    from bsyolo_tpu_torch.data.imread import imread

    root = Path(root)
    dota = read_yaml(Path(__file__).resolve().parent / "bsyolo_tpu_torch" / "cfg" / "datasets" / "DOTAv1.yaml")
    names = [dota["names"][k] for k in sorted(dota["names"])]
    t0 = time.perf_counter()
    obb_data = write_obb_jpeg_dataset(root / "obb", names, SEED + 40)
    cls_root = write_cls_jpeg_dataset(root / "cls", SEED + 43)
    print(f"phase 14 datasets: OBB {P14_OBB_TRAIN} train + {P14_OBB_VAL} val JPEG frames {P14_OBB_SIDE}x"
          f"{P14_OBB_SIDE}, {len(names)} classes (DOTA's); classify {P14_CLS_NC} classes x ({P14_CLS_TRAIN} train + "
          f"{P14_CLS_VAL} val) JPEG frames {P14_CLS_HW[0]}x{P14_CLS_HW[1]}; written in {time.perf_counter() - t0:.2f} s")
    d = load_dataset_yaml(str(obb_data))
    ds = YOLODataset(d["train"], imgsz=P14_OBB_SIDE, augment=True, hyp=dict(DEFAULT_CFG_DICT), task="obb")
    batch = next(iter(DataLoader(ds, P14_OBB_STEP_BATCH, shuffle=True, seed=3)))
    obb_graph = task_graph("yolo11n-obb.yaml", len(names), "cpu", SEED + 44)
    print(f"yolo11n-obb at nc {len(names)}: {sum(p.numel() for p in obb_graph.parameters())} parameters, head "
          f"{obb_graph.spec.head.module} with ne {obb_graph.spec.head.args[1]}")
    step_against_cpu(dev, "obb", obb_graph, batch, f"phase 14a obb train step, batch {P14_OBB_STEP_BATCH} at "
                     f"{P14_OBB_SIDE}")
    cds = ClassificationDataset(cls_root / "train", imgsz=P14_CLS_IMGSZ, augment=True, auto_augment="randaugment",
                                erasing=0.4)
    cbatch = next(iter(ClassifyLoader(cds, P14_CLS_STEP_BATCH, seed=3)))
    cls_graph = task_graph("yolo11n-cls.yaml", P14_CLS_NC, "cpu", SEED + 45)
    print(f"yolo11n-cls at nc {P14_CLS_NC}: {sum(p.numel() for p in cls_graph.parameters())} parameters")
    step_against_cpu(dev, "classify", cls_graph, cbatch, f"phase 14a classify train step, batch "
                     f"{P14_CLS_STEP_BATCH} at {P14_CLS_IMGSZ}")
    out = {}
    for task, yaml, data, kw in (
            ("obb", "yolo11n-obb.yaml", str(obb_data), dict(imgsz=P14_OBB_SIDE, batch=P14_OBB_BATCH, close_mosaic=1,
                                                             plots=False)),
            ("classify", "yolo11n-cls.yaml", str(cls_root), dict(imgsz=P14_CLS_IMGSZ, batch=P14_CLS_BATCH))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        model = YOLO(yaml)
        t1 = time.perf_counter()
        model.train(data=data, epochs=2, amp=False, workers=P14_WORKERS, seed=3, project=str(root / "runs"),
                    name=task, exist_ok=True, **kw)
        train_s = time.perf_counter() - t1
        best = root / "runs" / task / "weights" / "best.ckpt"
        loaded = YOLO(best)
        want_nc = len(names) if task == "obb" else P14_CLS_NC
        if loaded.task != task or loaded.spec.nc != want_nc:
            raise SystemExit(f"YOLO(best.ckpt) rebuilt a {loaded.task} graph with nc {loaded.spec.nc}")
        t2 = time.perf_counter()
        metrics = loaded.val(data=data, batch=kw["batch"])
        torch.cuda.synchronize()
        val_s = time.perf_counter() - t2
        if task == "obb":
            frames = [imread(p) for p in sorted((root / "obb" / "images" / "val").glob("*.jpg"))]
            res = loaded.predict(frames, imgsz=kw["imgsz"], batch=4, conf=CONF)
        else:  # from the files, so each result's path names its class folder
            frames = [imread(p) for p in sorted((cls_root / "val").rglob("*.jpg"))]
            res = loaded.predict(str(cls_root / "val"), imgsz=kw["imgsz"], batch=4)
        torch.cuda.synchronize()
        expect_launches(f"{task} trainer and facade", NO_LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        steps = []
        for e, (wait, wall, n) in enumerate(model.trainer.loader_wait):
            steps.append(wall * 1e3 / n)
            print(f"  {task} epoch {e}: {n} steps in {wall:.2f} s, {wall * 1e3 / n:.1f} ms per step (host clock, "
                  f"loader in the loop, {P14_WORKERS} workers), loader-wait share {wait / wall:.3f}"
                  + (", the pool starts" if e == 0 else ""))
        n_val = P14_OBB_VAL if task == "obb" else P14_CLS_NC * P14_CLS_VAL
        payload = [r.obb.data if task == "obb" else r.probs.data for r in res]
        if not all(np.isfinite(p).all() for p in payload) or (task == "classify" and any(
                abs(float(p.sum()) - 1) > 1e-4 for p in payload)):
            raise SystemExit(f"{task} predict through best.ckpt gave rows that are not finite (or not probabilities)")
        print(f"phase 14b {task}: YOLO.train 2 epochs in {train_s:.1f} s, peak memory allocated {peak_gb:.2f} GB; "
              f"val {val_s * 1e3 / n_val:.2f} ms per image: "
              f"{', '.join(f'{k} {float(v):.4f}' for k, v in metrics.results_dict.items())}; predict over "
              f"{len(res)} frames: " + (f"{sum(len(r) for r in res)} rows" if task == "obb" else "top-1 accuracy "
                                        f"{np.mean([r.probs.top1 == int(Path(r.path).parent.name[5:]) for r in res]):.3f}"))
        out[task] = {"train_s": train_s, "ms_per_step": steps, "peak_gb": peak_gb}
        kernels.reset_launch_counts()
        if task == "obb":
            obb_predict_against_cpu(dev, best, frames)
        else:
            cls_predict_against_cpu(dev, frames, root)
        expect_launches(f"{task} card vs CPU predict", NO_LAUNCHES)
    return dict(NO_LAUNCHES)


# phase 15: the bf16 graph and int8 on the four task graphs (amp training, half and int8 predict and val)
P15_AMP_LOSS_RTOL = 5e-2  # amp step loss items, card vs CPU, both bf16 graphs (tests/test_torch_task_bf16.py's gate)
P15_HALF_NORM = 7.5e-3  # bf16 head levels and logits, card vs CPU, of their norm (the CPU tests' graph gate)
P15_PROTO_NORM = 1e-2  # bf16 prototypes, four layers that each round (the CPU tests' block gate)
P15_VAL_ATOL = 0.02  # val metrics, card vs CPU on the same weights and images (the CPU tests' gate)
P15_OWN = 4  # the images of each set's own split, validated on and predicted
P15_SIGNAL = 0.3  # the floor of the main metric of every val on the fitted weights, card and CPU
P15_CONF = 0.001  # predict as val does: a fit stopped at its first epoch past P15_STOP may score below 0.25
P15_WORKERS = 0  # the loader in the trainer's thread, its images cached: phases 13b and 14b drive the spawned pool
# the fit to the own split (the CPU tests' trained_task_checkpoint): SGD at a fixed rate, no augmentation
P15_FIT = dict(optimizer="SGD", lr0=0.02, warmup_epochs=0.0, close_mosaic=0, mosaic=0.0, fliplr=0.0, hsv_h=0.0,
               hsv_s=0.0, hsv_v=0.0, translate=0.0, scale=0.0, workers=P15_WORKERS, plots=False, seed=3)
# task -> (copies of each own image in the training split (classify trains on its train split), batch, most
# epochs). In my chip runs at batch 8 and 8 steps per epoch box mAP50 first passed 0.3 after 80 to 88 steps
# (detect, segment, obb) and pose's after 56
# steps in one run and none of 96 in another, so a fit stops after the first epoch whose main metric passes
# P15_STOP (classify, whose trainer has no stopper, runs its epochs). Stopped on the climb (OBB at mAP50 0.62),
# a bf16 graph's rounding moved the CPU's mAP50 by 0.036: fitted further, scores part and metrics settle
P15_FITS = {"detect": (16, 8, 30), "segment": (16, 8, 30), "pose": (16, 8, 30), "obb": (8, 4, 40),
            "classify": (1, 16, 16)}
P15_STOP = 0.9
# classify validates on all P14_CLS_NC x (P14_CLS_TRAIN + P14_CLS_VAL) images: on 40 one image is 0.025 of top-1,
# past P15_VAL_ATOL, and one flipped where the bf16 logits round apart in my chip run (0.8000 against 0.7750)
P15_CLS_VAL_BATCH = 32
# (task, graph, classes, imgsz, the main val metric); the datasets are phase 13's and 14's
P15_TASKS = (("segment", "yolo11n-seg.yaml", 80, IMGSZ, "metrics/mAP50(B)"),
             ("pose", "yolo11n-pose.yaml", 1, IMGSZ, "metrics/mAP50(B)"),
             ("obb", "yolo11n-obb.yaml", 15, P14_OBB_SIDE, "metrics/mAP50(B)"),
             ("classify", "yolo11n-cls.yaml", P14_CLS_NC, P14_CLS_IMGSZ, "metrics/accuracy_top1"))


def own_split(d, ext: str, copies: int):
    """The first P15_OWN val images of the images/labels set at ``d`` as a split of their own (``images/own``),
    ``copies`` hard links of each in ``images/rep``, and ``own.yaml``, which trains on ``rep`` and validates on
    ``own``; returns (the YAML, the own split's frames)."""
    import shutil

    from bsyolo_tpu_torch.data.imread import imread

    files = sorted((d / "images" / "val").glob(f"*.{ext}"))[:P15_OWN]
    for sub, split in itertools.product(("images", "labels"), ("own", "rep")):
        (d / sub / split).mkdir()
    for p in files:
        shutil.copy(p, d / "images" / "own" / p.name)
        shutil.copy(d / "labels" / "val" / f"{p.stem}.txt", d / "labels" / "own" / f"{p.stem}.txt")
        for r in range(copies):
            os.link(d / "images" / "own" / p.name, d / "images" / "rep" / f"{p.stem}_{r}.{ext}")
            os.link(d / "labels" / "own" / f"{p.stem}.txt", d / "labels" / "rep" / f"{p.stem}_{r}.txt")
    yaml = d / "own.yaml"
    text = (d / "data.yaml").read_text()
    yaml.write_text(text.replace("train: images/train\n", "train: images/rep\n").replace(
        "val: images/val\n", "val: images/own\n"))
    return yaml, [imread(p) for p in sorted((d / "images" / "own").glob(f"*.{ext}"))]


def task_datasets(root):
    """task -> (the data to fit and validate on, the frames validated on): own splits of phase 13's and 14's
    datasets under ``root``; classify's trains on its train split and validates on its train and val splits."""
    from bsyolo_tpu_torch.data.imread import imread

    root, out = Path(root), {}
    for task, *_ in P15_TASKS:
        copies = P15_FITS[task][0]
        if task != "classify":
            out[task] = own_split(root / task, "jpg", copies)
            continue
        own = root / "cls_own"
        for src in sorted((root / "cls").glob("*/*/*.jpg")):  # {train,val}/class<c>/<i>.jpg
            split, c = src.parent.parent.name, src.parent.name
            val = own / "val" / c / f"{split}_{src.name}"
            for dst in ([own / "train" / c / src.name] if split == "train" else []) + [val]:
                dst.parent.mkdir(parents=True, exist_ok=True)
                os.link(src, dst)
        out[task] = (own, [imread(p) for p in sorted((own / "val").rglob("*.jpg"))])
    return out


def fit_own_split(task, yaml, data, imgsz, root, name, main):
    """``YOLO(yaml).train`` with its default amp on ``data`` (an own split), fitted as P15_FIT and P15_FITS say,
    stopping after the first epoch whose ``main`` metric passes P15_STOP; returns (the facade, the seconds)."""
    from bsyolo_tpu_torch import YOLO

    def stop_on_signal(trainer):
        if float(trainer.metrics.results_dict[main]) > P15_STOP:
            trainer.stopper.patience = 0  # the trainer stops after this epoch's checkpoints

    _, batch, epochs = P15_FITS[task]
    model = YOLO(yaml)
    if task == "classify":
        kw = dict(auto_augment="", erasing=0.0)  # the random resized crop stays
    else:
        kw = dict(cache="ram")
        model.add_callback("on_fit_epoch_end", stop_on_signal)
    t0 = time.perf_counter()
    model.train(data=str(data), epochs=epochs, imgsz=imgsz, batch=batch, nbs=batch, name=name, exist_ok=True,
                project=str(Path(root) / "runs"), **kw, **P15_FIT)
    return model, time.perf_counter() - t0


def task_batch_for(task, data, imgsz, batch):
    """One augmented loader batch of the task's training set."""
    from bsyolo_tpu_torch.cfg import DEFAULT_CFG_DICT
    from bsyolo_tpu_torch.data import DataLoader, YOLODataset, load_dataset_yaml
    from bsyolo_tpu_torch.data.classify import ClassificationDataset, ClassifyLoader

    if task == "classify":
        ds = ClassificationDataset(Path(data) / "train", imgsz=imgsz, augment=True, auto_augment="randaugment")
        return next(iter(ClassifyLoader(ds, batch, seed=3)))
    d = load_dataset_yaml(str(data))
    ds = YOLODataset(d["train"], imgsz=imgsz, augment=True, hyp=dict(DEFAULT_CFG_DICT), task=task,
                     flip_idx=d.get("flip_idx"))
    return next(iter(DataLoader(ds, batch, shuffle=True, seed=3)))


def head_maps(out):
    """A graph's output -> [(name, tensor)]: the levels, a Segment head's prototypes, a Classify head's logits."""
    if isinstance(out, dict):
        return [(f"level {i}", f) for i, f in enumerate(out["feats"])] + [("proto", out["proto"])]
    return [(f"level {i}", f) for i, f in enumerate(out)] if isinstance(out, list) else [("logits", out)]


def replayed_rows(task, card, best, graph, frames, imgsz, label, **kw):
    """``card.predict(frames, **kw)`` at batch 4 with ``graph``'s outputs recorded, and the CPU's predictor run on
    those outputs (a Replay): the rows (masks, keypoints, rotated rows, probabilities) held against the CPU's;
    returns (ms per batch of 4, the card's results)."""
    import torch

    from bsyolo_tpu_torch import YOLO

    recorded = []
    hook = graph.register_forward_hook(lambda module, args, output: recorded.append(_to(output, "cpu")))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        got = card.predict(frames, imgsz=imgsz, batch=4, conf=P15_CONF, **kw)
        torch.cuda.synchronize()
    finally:
        hook.remove()
    ms = (time.perf_counter() - t0) * 1e3 / math.ceil(len(frames) / 4)
    replay = YOLO(best, device="cpu")
    replay.model = Replay(recorded)
    want = replay.predict(frames, imgsz=imgsz, batch=4, conf=P15_CONF)
    if task == "classify":
        err = max(float(np.abs(g.probs.data - w.probs.data).max()) for g, w in zip(got, want))
        top5 = all(g.probs.top5 == w.probs.top5 for g, w in zip(got, want))
        print(f"  {label}: {ms:.1f} ms per batch of 4; probabilities against the CPU's softmax of the card's logits: "
              f"max |diff| {err:.3g} (tol {P14_PROB_ATOL}), top 5 equal {top5}")
        if not (top5 and err <= P14_PROB_ATOL):
            raise SystemExit(f"{label}: the card's probabilities differ from the CPU's on the same logits")
        return ms, got
    if task == "obb":
        pairs = [obb_pairs(g.obb.data, w.obb.data) for g, w in zip(got, want)]
        rows = sum(len(r) for r in got)
        frac = sum(len(p) for p in pairs) / max(rows, sum(len(r) for r in want), 1)
        print(f"  {label}: {ms:.1f} ms per batch of 4, {rows} rotated rows; {frac:.4f} paired with the CPU's "
              f"postprocess on the card's head maps (tol {MATCH_MIN_FRACTION})")
        if not (rows and frac >= MATCH_MIN_FRACTION):
            raise SystemExit(f"{label}: the card's rotated rows differ from the CPU's on the same head maps")
        return ms, got
    if not sum(len(r) for r in got):
        raise SystemExit(f"{label}: no rows at conf {P15_CONF}")
    compare_with_cpu(f"{label}, the CPU's path on the card's head maps", [r.boxes.data for r in got],
                     [r.boxes.data for r in want])
    first, second = _paired_payloads(task, got, want)
    print(f"  {label}: {ms:.1f} ms per batch of 4, {sum(len(r) for r in got)} rows; paired "
          + (f"masks' mean IoU {first:.5f} (tol {P13_MASK_IOU})" if task == "segment" else
             f"keypoints within {first:.3g} px (tol {P13_KPT_PX})"))
    if (task == "segment" and first < P13_MASK_IOU) or (task == "pose" and first > P13_KPT_PX):
        raise SystemExit(f"{label}: the card's masks or keypoints differ from the CPU's on the same head maps")
    return ms, got


RANKED = ("mAP", "accuracy", "fitness")  # metrics of the ranked rows, against precision and recall at one conf


def val_against_cpu(label, card, host, best, data, imgsz, batch, main, **kw):
    """``val`` on the card, and on the CPU twice with the same weights (``best``) and images: the CPU's validator
    on the card's head maps (a Replay), every metric within P15_VAL_ATOL; the CPU's own graph, whose head maps
    round apart from the card's, the ranked metrics (mAP, accuracy, fitness) within P15_VAL_ATOL, precision and
    recall printed (read at the peak of the F1 curve, they jump when one row's score crosses another's); the
    ``main`` metric above P15_SIGNAL on all three (the weights were fitted to these images)."""
    import torch

    from bsyolo_tpu_torch import YOLO

    graph = card.half_graph() if kw.get("half") else card.model
    recorded = []
    hook = graph.register_forward_hook(lambda module, args, output: recorded.append(_to(output, "cpu")))
    t0 = time.perf_counter()
    try:
        got = card.val(data=str(data), batch=batch, imgsz=imgsz, **kw).results_dict
        torch.cuda.synchronize()
    finally:
        hook.remove()
    card_s = time.perf_counter() - t0
    replay = YOLO(best, device="cpu")
    replay.model = Replay(recorded)
    same = replay.val(data=str(data), batch=batch, imgsz=imgsz, **{k: v for k, v in kw.items() if k != "half"})
    same = same.results_dict
    own = host.val(data=str(data), batch=batch, imgsz=imgsz, **kw).results_dict
    replayed = max(abs(float(got[k]) - float(same[k])) for k in same)
    ranked = max(abs(float(got[k]) - float(own[k])) for k in own if any(r in k for r in RANKED))
    print(f"  {label}, card / CPU on the card's head maps / CPU's own graph: "
          f"{', '.join(f'{k} {float(got[k]):.4f}/{float(same[k]):.4f}/{float(own[k]):.4f}' for k in own)}; max "
          f"|diff| {replayed:.3g} on the same head maps (every metric), {ranked:.3g} against the CPU's graph (ranked "
          f"metrics; tol {P15_VAL_ATOL}); {main} floor {P15_SIGNAL}; card {card_s:.2f} s")
    if not got.keys() == same.keys() == own.keys():
        raise SystemExit(f"{label}: the card's metrics are not the CPU's")
    if not (replayed <= P15_VAL_ATOL and ranked <= P15_VAL_ATOL):
        raise SystemExit(f"{label} on the card differs from the CPU's")
    if not min(float(got[main]), float(same[main]), float(own[main])) > P15_SIGNAL:
        raise SystemExit(f"{label}: {main} is not above {P15_SIGNAL} on the weights fitted to these images")
    return got


def drawn_amp_reading(dev, task, graph, batch):
    """15a's reading from drawn weights, printed and not held: one float32 and one amp step on the CPU and on the
    card, each device's bf16 loss items against its own float32 items and the devices against each other."""
    import torch

    items = {(where, kind): one_step(graph, batch, torch.device(on), dtype)[0]
             for where, on in (("cpu", "cpu"), ("card", dev))
             for kind, dtype in (("f32", None), ("bf16", torch.bfloat16))}

    def rel(a, b):
        return [float(f"{v:.3g}") for v in np.abs(items[a] - items[b]) / np.maximum(np.abs(items[b]), 1e-30)]

    print(f"  {task} amp step from drawn weights (printed): loss items CPU float32 {items['cpu', 'f32'].tolist()}, "
          f"bf16 {items['cpu', 'bf16'].tolist()}; card float32 {items['card', 'f32'].tolist()}, bf16 "
          f"{items['card', 'bf16'].tolist()}; rel diff bf16 from float32 on the CPU "
          f"{rel(('cpu', 'bf16'), ('cpu', 'f32'))}, "
          f"on the card {rel(('card', 'bf16'), ('card', 'f32'))}; card vs CPU float32 "
          f"{rel(('card', 'f32'), ('cpu', 'f32'))}, bf16 {rel(('card', 'bf16'), ('cpu', 'bf16'))}")


def task_modes_path(dev, root):
    """Phase 15: the bf16 graph and int8 on yolo11n-seg, -pose, -obb and -cls at phases 13's and 14's widths:
    (a) one amp step card vs CPU on phase 13's and 14's training sets (and, for segment, a printed reading from
    drawn weights); (b) YOLO.train with its default amp, fitted to an own split of P15_OWN images (classify:
    its val split) as P15_FITS says, so that the metrics below carry signal (the bf16 graph trains and
    validates; the facade keeps it); (c) on the fitted weights: the bf16 head card vs CPU, predict(half=True)
    rows against the CPU's predictor on the card's head maps, val(half=True) as val_against_cpu holds it; (d)
    calibrate_int8 on
    the CPU, the same scales on both: int8 head maps card vs CPU, int8 predict rows as in (c), int8 val as in (c),
    int8 predict on half_graph(); each val above P15_SIGNAL; (e) int8_matmul over the products of one
    forward of each graph at batch 4, float32 and bf16 out, beside its bound, the plain version and
    torch._int_mm. Returns (the launches, int8_matmul's figures per graph)."""
    import torch

    from bsyolo_tpu_torch import YOLO, kernels
    from bsyolo_tpu_torch.data.classify import ClassificationDataset, ClassifyLoader
    from bsyolo_tpu_torch.nn.model import compute_dtype
    from bsyolo_tpu_torch.nn.modules import quantizable_convs, set_int8_inference
    from bsyolo_tpu_torch.nn.quant import calibrate_int8
    from bsyolo_tpu_torch.ops.letterbox import letterbox

    data = task_datasets(root)
    total = {"decode_box_best": 0, "decode_xywh": 0, "int8_matmul": 0}
    figures = {}

    def count(path, expected):
        launches = expect_launches(path, expected)
        for k in total:
            total[k] += launches[k]
        kernels.reset_launch_counts()

    for i, (task, yaml, nc, imgsz, main) in enumerate(P15_TASKS):
        t_task = time.perf_counter()
        own, frames = data[task]
        step_batch = {"segment": P13_STEP_BATCH, "pose": P13_STEP_BATCH, "obb": P14_OBB_STEP_BATCH}.get(
            task, P14_CLS_STEP_BATCH)
        train_set = Path(root) / ("cls" if task == "classify" else f"{task}/data.yaml")
        batch = task_batch_for(task, train_set, imgsz, step_batch)
        # the seeded init training starts from: drawn weights' spread logits make bf16 rounding, carried through
        # train-mode BatchNorm over the whole depth, move yolo11n-seg's mask and class terms past the gate on both
        # devices alike (the reading below)
        step_against_cpu(dev, task, task_graph(yaml, nc, "cpu", SEED + 50 + i, drawn=False), batch,
                         f"phase 15a {task} amp step, batch {step_batch}", torch.bfloat16, P15_AMP_LOSS_RTOL)
        if task == "segment":
            drawn_amp_reading(dev, task, task_graph(yaml, nc, "cpu", SEED + 50 + i), batch)
        detects = task in ("segment", "pose")  # heads that go through decode_box
        _, fit_batch, _ = P15_FITS[task]
        val_batch = P15_CLS_VAL_BATCH if task == "classify" else P15_OWN
        n_val = math.ceil(len(frames) / val_batch)
        n_pred = math.ceil(len(frames[:P15_OWN]) / 4)

        # (b) YOLO.train with its default amp, fitted to the own split
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        model, train_s = fit_own_split(task, yaml, own, imgsz, root, f"p15{task}", main)
        tr = model.trainer
        if not (tr.args.amp is True and compute_dtype(tr.model) == torch.bfloat16 and compute_dtype(model.model)
                == torch.bfloat16 and not model.model.training and all(p.dtype == torch.float32
                                                                        for p in model.model.parameters())):
            raise SystemExit(f"{task}: YOLO.train with its defaults did not train and keep the bf16 graph")
        epochs = len(tr.loader_wait)
        count(f"{task} amp training", {"decode_box_best": epochs * math.ceil(len(frames) / fit_batch) if detects
                                       else 0, "decode_xywh": 0, "int8_matmul": 0})
        wait, wall, n = (sum(e[k] for e in tr.loader_wait) for k in range(3))
        fitted = tr.metrics.results_dict
        print(f"phase 15b {task}: YOLO.train (amp, the default) {epochs} epochs at batch {fit_batch} on "
              f"{len(tr.train_loader.dataset)} images, validated on {len(frames)}, in {train_s:.1f} s; {n} steps, "
              f"{wall * 1e3 / n:.1f} ms per step (the loader in the trainer's thread), loader-wait share "
              f"{wait / wall:.3f}; peak memory allocated "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB; "
              f"{', '.join(f'{k} {float(v):.4f}' for k, v in fitted.items())}")
        if not float(fitted[main]) > P15_SIGNAL:
            raise SystemExit(f"{task}: {epochs} epochs on {len(frames)} images left {main} at "
                             f"{float(fitted[main]):.4f}, not above {P15_SIGNAL}")

        # (c) half: the fitted weights, on the card and on the CPU
        frames = frames[:P15_OWN]
        best = Path(root) / "runs" / f"p15{task}" / "weights" / "best.ckpt"
        host, card = YOLO(best, device="cpu"), YOLO(best)
        x = torch.stack([letterbox(f, (imgsz, imgsz), "cpu") for f in frames]).float() / 255.0
        with torch.inference_mode():
            want16, got16 = host.half_graph()(x), _to(card.half_graph()(x.to(dev)), "cpu")
            f32 = host.model(x)
        for (name, w), (_, g) in zip(head_maps(want16), head_maps(got16)):
            err = ((g.float() - w.float()).norm() / w.float().norm()).item()
            tol = P15_PROTO_NORM if name == "proto" else P15_HALF_NORM
            print(f"  {task} bf16 {name} {tuple(w.shape[1:])} card vs CPU: {err:.3g} of its norm (tol {tol})")
            if not (err <= tol and g.dtype == w.dtype == torch.bfloat16):
                raise SystemExit(f"{task}: the bf16 head on the card is not the CPU's within {tol}")
        card.predict(frames, imgsz=imgsz, batch=4, conf=P15_CONF, half=True)  # warm-up: cuDNN's bf16 plans
        kernels.reset_launch_counts()
        half_ms, _ = replayed_rows(task, card, best, card.half_graph(), frames, imgsz, f"{task} predict(half=True)",
                                   half=True)
        count(f"{task} predict(half=True)", {"decode_box_best": n_pred if detects else 0, "decode_xywh": 0,
                                             "int8_matmul": 0})
        val_against_cpu(f"{task} val(half=True)", card, host, best, own, imgsz, val_batch, main, half=True)
        count(f"{task} val(half=True)", {"decode_box_best": n_val if detects else 0, "decode_xywh": 0,
                                         "int8_matmul": 0})

        # (d) int8, the CPU's calibration on both
        card.predict(frames, imgsz=imgsz, batch=4, conf=P15_CONF)  # warm-up of the float graph
        kernels.reset_launch_counts()
        float_ms = replayed_rows(task, card, best, card.model, frames, imgsz, f"{task} predict (float32, in turn)")[0]
        count(f"{task} float predict", {"decode_box_best": n_pred if detects else 0, "decode_xywh": 0,
                                        "int8_matmul": 0})
        if task == "classify":  # the validator's centre crops of every class (the first frames are all class 0)
            ds = ClassificationDataset(Path(own) / "val", imgsz=imgsz, augment=False)
            cal = next(iter(ClassifyLoader(ds, P15_CLS_VAL_BATCH, shuffle=True, seed=3)))["img"]
            scales = calibrate_int8(host.model, [torch.as_tensor(cal).permute(0, 3, 1, 2).contiguous()])
        else:
            scales = calibrate_int8(host.model, [x])
        n_convs = len(quantizable_convs(card.model))
        set_int8_inference(host.model, True, scales)
        set_int8_inference(card.model, True, scales)
        try:
            # each int8 conv is held to its CPU twin on the same input (as phase 6): over the whole graph, codes
            # that flip where cuDNN's and the CPU's float layers round apart move the codes after them, so the
            # head maps are printed, not held
            check_int8_convs_against_cpu(dev, host, card, frames, imgsz)
            with torch.inference_mode():
                want8, got8 = host.model(x), _to(card.model(x.to(dev)), "cpu")
            for (name, w), (_, g), (_, f) in zip(head_maps(want8), head_maps(got8), head_maps(f32)):
                scale = w.abs().max().item()
                diff, gap = (g - w).abs(), (w - f).abs()
                print(f"  {task} int8 {name} card vs CPU (printed): median |diff| {diff.median().item() / scale:.3g}, "
                      f"largest {diff.max().item() / scale:.3g} of the scale; int8 against float on the CPU: median "
                      f"{gap.median().item() / scale:.3g}, largest {gap.max().item() / scale:.3g}")
            kernels.reset_launch_counts()
            card.predict(frames, imgsz=imgsz, batch=4, conf=P15_CONF)  # warm-up: the weight codes
            kernels.reset_launch_counts()
            int8_ms = replayed_rows(task, card, best, card.model, frames, imgsz, f"{task} int8 predict")[0]
            count(f"{task} int8 predict", {"decode_box_best": n_pred if detects else 0, "decode_xywh": 0,
                                           "int8_matmul": n_convs * n_pred})
            val_against_cpu(f"{task} int8 val", card, host, best, own, imgsz, val_batch, main)
            count(f"{task} int8 val", {"decode_box_best": n_val if detects else 0, "decode_xywh": 0,
                                       "int8_matmul": n_convs * n_val})
            card.predict(frames, imgsz=imgsz, batch=4, conf=P15_CONF, half=True)  # a new bf16 copy with int8
            kernels.reset_launch_counts()
            half8_ms = replayed_rows(task, card, best, card.half_graph(), frames, imgsz,
                                     f"{task} int8 predict(half=True)", half=True)[0]
            count(f"{task} int8 predict(half=True)", {"decode_box_best": n_pred if detects else 0, "decode_xywh": 0,
                                                      "int8_matmul": n_convs * n_pred})
        finally:
            set_int8_inference(host.model, False)
            set_int8_inference(card.model, False)
        print(f"phase 15 {task}: ms per predict batch of 4 (host clock): float32 {float_ms:.1f}, half {half_ms:.1f}, "
              f"int8 {int8_ms:.1f}, int8 half {half8_ms:.1f}; {n_convs} quantized convs")

        # (e) int8_matmul over the products of one forward of this graph
        shapes = path_products(card, dev, imgsz)
        figures[task] = time_path_products(dev, shapes, f"{task} ({yaml}, batch 4, {imgsz} px)", detail=False)
        del host, card, model
        torch.cuda.empty_cache()
        print(f"phase 15 {task} done in {time.perf_counter() - t_task:.1f} s")
    return total, figures


def detect_int8_val(dev, data, root):
    """Phase 15f: yolo11n fitted to an own split of phase 9's val images (as 15b), then int8 val on it, the
    CPU's calibration on both: metrics as val_against_cpu holds them, mAP50 above P15_SIGNAL; int8_matmul 74
    times per validation batch."""
    import torch

    from bsyolo_tpu_torch import YOLO, kernels
    from bsyolo_tpu_torch.nn.modules import quantizable_convs, set_int8_inference
    from bsyolo_tpu_torch.nn.quant import calibrate_int8
    from bsyolo_tpu_torch.ops.letterbox import letterbox

    own, frames = own_split(Path(data).parent, "png", P15_FITS["detect"][0])
    fitted, train_s = fit_own_split("detect", "yolo11n.yaml", own, IMGSZ, root, "p15detect", "metrics/mAP50(B)")
    metrics = fitted.trainer.metrics.results_dict
    print(f"phase 15f: yolo11n fitted to {len(frames)} images in {len(fitted.trainer.loader_wait)} epochs in "
          f"{train_s:.1f} s "
          f"(amp, the default); {', '.join(f'{k} {float(v):.4f}' for k, v in metrics.items())}")
    best = Path(root) / "runs" / "p15detect" / "weights" / "best.ckpt"
    host, card = YOLO(best, device="cpu"), YOLO(best)
    x = torch.stack([letterbox(f, (IMGSZ, IMGSZ), "cpu") for f in frames]).float() / 255.0
    scales = calibrate_int8(host.model, [x])
    n_convs = len(quantizable_convs(card.model))
    set_int8_inference(host.model, True, scales)
    set_int8_inference(card.model, True, scales)
    try:
        kernels.reset_launch_counts()
        val_against_cpu("detect int8 val (yolo11n fitted to them)", card, host, best, own, IMGSZ, P15_OWN,
                        "metrics/mAP50(B)")
        launches = expect_launches("detect int8 val", {"decode_box_best": 1, "decode_xywh": 0,
                                                       "int8_matmul": n_convs})
    finally:
        set_int8_inference(host.model, False)
        set_int8_inference(card.model, False)
    return launches


def kernel_entry(name, source, replaces, launches, row, bf16_launches, bf16_head=None, product_launches=0,
                 photo_launches=0, task_launches=0, mode_launches=0):
    """One entry of the kernels line; ``launches`` counts every path's run, ``bf16_launches`` those of
    phase 10's bf16 paths among them, ``product_launches`` those of phase 11's product path,
    ``photo_launches`` those of phase 12's real photos, ``task_launches`` those of phase 13's and 14's task
    paths, ``mode_launches`` those of phase 15's bf16 and int8 paths (the four task graphs and Detect's int8
    val), ``bf16_head`` the kernel on a real forward's bf16 head."""
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
            "bf16_launches": bf16_launches, "product_launches": product_launches, "photo_launches": photo_launches,
            "task_launches": task_launches, "mode_launches": mode_launches,
            **({"task_heads": row["task_heads"]} if "task_heads" in row else {}),
            **({"task_graphs": row["task_graphs"]} if "task_graphs" in row else {}),
            **({"bf16_head": bf16_head} if bf16_head else {}),
            "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": row.get("library_ms"),
            "shape": row["shape"], "call_ms": row["call_ms"], "plain_call_ms": row["plain_call_ms"],
            **({"host_us_per_call": row["host_us_per_call"]} if "host_us_per_call" in row else {}),
            **({"two_byte_levels": row["two_byte_levels"]} if "two_byte_levels" in row else {}),
            **({"bf16_out": row["bf16_out"]} if "bf16_out" in row else {})}


def phase(name: str, fn, *args):
    """Run one phase of the smoke and print its seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name} done in {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available; this script runs only on one", file=sys.stderr)
        return 1
    from bsyolo_tpu_torch import select_device

    torch.backends.cudnn.allow_tf32 = False  # every phase, training and validation included
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = select_device(None)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, TF32 off")
    t0 = time.perf_counter()
    phase("1 (build)", build_kernels)
    t2 = time.perf_counter()
    box_row = check_decode_kernel(dev)
    box_row["task_heads"] = check_decode_task_heads(dev)
    xywh_row = check_decode_xywh_kernel(dev)
    half_rows = check_decode_2_byte_levels(dev)
    box_row["two_byte_levels"] = half_rows["decode_box_best"]
    xywh_row["two_byte_levels"] = half_rows["decode_xywh"]
    int8_err = check_int8_kernel(dev)
    print(f"phase 2 done in {time.perf_counter() - t2:.1f} s")
    host, model, frames = make_models(dev)
    predict_launches = phase("3", predict_path, dev, host, model, frames)
    tta_launches = phase("4", tta_path, host, model, frames)
    tiled_launches = phase("5", tiled_path, host, model)
    int8_launches, int8_row = phase("6", int8_path, dev, host, model, frames)
    # 10a to 10c drive the inference paths on the bf16 graph while the float graph is as phases 3 to 6 left it;
    # 10d and 10e come after the training phases whose figures and dataset they use
    half_launches, box_half = phase("10a", half_predict_path, dev, host, model, frames)
    half_xywh_launches, xywh_half = phase("10b", half_tta_tiled_path, model, frames)
    half_int8_launches = phase("10c", half_int8_path, dev, host, model, frames)
    seeded = {k: v.clone() for k, v in model.model.state_dict().items()}
    referee = phase("7a", train_step_against_cpu, dev, host, model)
    model.model.load_state_dict(seeded)  # 7b starts from the seeded weights too
    state, f32_step = phase("7b", train_path, dev, model)
    val_launches = phase("8", val_path, dev, host, model, state)
    del state
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        trainer_launches, data = phase("9", trainer_path, dev, frames, Path(root))
        phase("10d", amp_step_path, dev, model, seeded, f32_step, referee)
        amp_launches = phase("10e", amp_trainer_path, dev, data, root)
        detect_int8_launches = phase("15f", detect_int8_val, dev, data, root)
    product_launches = phase("11", product_path, dev)
    photo_launches = phase("12", photo_path, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:  # phase 15 takes 13's and 14's datasets
        task_launches = phase("13", task_path, dev, root)
        obb_cls_launches = phase("14", obb_classify_path, dev, root)
        mode_launches, int8_row["task_graphs"] = phase("15", task_modes_path, dev, root)
    task_launches = {k: task_launches[k] + obb_cls_launches[k] for k in task_launches}
    mode_launches = {k: mode_launches[k] + detect_int8_launches[k] for k in mode_launches}
    bf16 = {k: half_launches[k] + half_xywh_launches[k] + half_int8_launches[k] + amp_launches[k]
            for k in half_launches}
    kernels_line = {"kernels": [
        kernel_entry("decode_box_best", "bsyolo_tpu_torch/kernels/csrc/decode.cu", "bsyolo_tpu/kernels/decode.py:124",
                     predict_launches["decode_box_best"] + val_launches["decode_box_best"]
                     + trainer_launches["decode_box_best"] + bf16["decode_box_best"]
                     + product_launches["decode_box_best"] + photo_launches["decode_box_best"]
                     + task_launches["decode_box_best"] + mode_launches["decode_box_best"], box_row,
                     bf16["decode_box_best"], box_half, product_launches["decode_box_best"],
                     photo_launches["decode_box_best"], task_launches["decode_box_best"],
                     mode_launches["decode_box_best"]),
        kernel_entry("decode_xywh", "bsyolo_tpu_torch/kernels/csrc/decode.cu",
                     "bsyolo_tpu/kernels/decode.py:34",
                     tta_launches["decode_xywh"] + tiled_launches["decode_xywh"] + bf16["decode_xywh"], xywh_row,
                     bf16["decode_xywh"], xywh_half),
        kernel_entry("int8_matmul", "bsyolo_tpu_torch/kernels/csrc/int8_matmul.cu",
                     "bsyolo_tpu/kernels/int8_matmul.py:38",
                     int8_launches["int8_matmul"] + bf16["int8_matmul"] + mode_launches["int8_matmul"],
                     dict(max_abs_err=int8_err, **int8_row), bf16["int8_matmul"],
                     mode_launches=mode_launches["int8_matmul"]),
    ]}
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
