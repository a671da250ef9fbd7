#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bsyolo_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (PATH or $CUDA_HOME/bin) and this checkout; exits
non-zero without them. Phases, each of which fails the run on its own:

1. the card's name and power limit; every kernel of the port built with
   nvcc from ``bsyolo_tpu_torch/kernels/csrc``, one nvcc per source, all at once;
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
   laid out as the conv path lays them out, so the wrapper copies nothing).

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

Phases 10a to 10c run right after phase 6, on the float graph phases 3 to 6
used; 10d and 10e after phase 9. Each phase prints its seconds. Every launch counter is set to 0 just before a path is driven and read just
after, so each path shows the kernels it went through.

TF32 is off for convolutions and matrix products throughout, so the card and
the CPU compute the same float32 function (cuDNN would otherwise run float32
convolutions in TF32). The last two lines are the kernels JSON and
``{"ok": true, "device": {...}}``; in the kernels line each kernel carries its
launches on phase 10's bf16 paths (``bf16_launches``) among all its launches.
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import json
import math
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
    names = sorted({src for _, src in kernels.KERNELS.values()})
    build.compile_all(names)
    for name in names:
        rec = build.BUILD_LOG[name]
        src = build.CSRC / f"{name}.cu"
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


def check_decode_stage(label, decode, feats, reps: int = 50, counter=None):
    """``decode(feats)``, the decode stage as the path calls it, on head maps the path made
    (in L2, as when the head has just written them): fails unless each call runs exactly
    one device kernel, the decode kernel; prints its device time (torch.profiler, per
    recorded launch) and host time per call. With ``counter`` (a function reading the
    wrapper's launch count) the launches per call are the counter's and the profiler must
    see no other device item: in phase 10 its sessions recorded 43 to 49 of 50 launches
    (the same calls alone record 50 of 50)."""
    import torch
    from torch.autograd import DeviceType

    repeat(decode, [(feats,)], 3)()
    torch.cuda.synchronize()
    calls, launches = repeat(decode, [(feats,)], reps), []

    def run():  # profiled() may run a session again: the launches of the session it returns are the last
        before = counter() if counter else 0
        calls()
        launches.append(counter() - before if counter else 0)

    events = [e for e in profiled(run).events() if e.device_type == DeviceType.CUDA]
    launched = launches[-1] if counter else len(events)
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


def int8_bytes_ops(m, k, n):
    """Bytes the product must move (each input once, the float32 output once) and its operations."""
    return m * k + k * n + 4 * n + 4 + 4 * m * n, 2 * m * n * k


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
    identity, the head's last convs scaled by HEAD_GAIN (the default init
    leaves every logit at its bias, so every score ties)."""
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
        for branch in (*head.cv2, *head.cv3):
            branch[-1].weight.mul_(HEAD_GAIN)


def match_detections(got: np.ndarray, want: np.ndarray, box_px: float = MATCH_BOX_PX, score_tol: float = MATCH_SCORE):
    """Greedy match of each ``want`` row to the nearest unused ``got`` row of the
    same class, distance max(|box diff| / box_px, |score diff| / score_tol),
    accepted at distance <= 1; returns the (box err, score err) of every matched pair."""
    used = np.zeros(len(got), bool)
    errs = []
    for row in want:
        cand = np.flatnonzero(~used & (got[:, 5] == row[5]))
        if not len(cand):
            continue
        box = np.abs(got[cand, :4] - row[:4]).max(1)
        score = np.abs(got[cand, 4] - row[4])
        dist = np.maximum(box / box_px, score / score_tol)
        k = int(np.argmin(dist))
        if dist[k] <= 1.0:
            used[cand[k]] = True
            errs.append((float(box[k]), float(score[k])))
    return errs


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
    """Card detections against the CPU's, frame by frame, with match_detections; fails below
    ``min_fraction`` of the rows matched; returns the fraction."""
    n_want = n_got = same_frames = 0
    errs = []
    for g_, w in zip(got, want):
        e = match_detections(g_, w, box_px, score_tol)
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
                           lambda f: box_best(f, spec.head_strides, spec.nc, spec.reg_max), feats)

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
    return launches


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
                           lambda f: decode_detections(f, spec.head_strides, spec.nc, spec.reg_max), feats)

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
                           feats)

    check_finite("tiled", list(got.values()))
    compare_with_cpu("tiled, 2 frames", list(got.values()), [run(host, f) for f in big.values()])
    return launches


def path_products(model, dev):
    """(M, K, N) of the int8 matmul of every quantizable conv in one forward of a batch of 4 at IMGSZ."""
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
            model.model(torch.zeros((4, 3, IMGSZ, IMGSZ), device=dev))
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


def time_path_products(dev, shapes):
    """The kernel, its plain version and torch._int_mm over every product of one forward,
    each product's operands drawn anew (their sum far exceeds the L2) and laid out as the
    conv path lays them out, the weight prepared once as the conv path caches it: device
    ms per forward from torch.profiler, the share of it outside the kernel (must be 0),
    host time per call; the kernel held exactly to the plain version at each product."""
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
    # host time per call in turns (prepared weight, as the conv path calls it; int8_matmul_cuda, which
    # prepares the weight on every call; torch._int_mm + dequantization), twice each
    turns = [(label, host_us(fn, inputs, 5)) for _ in range(2) for label, fn, inputs in (
        ("prepared", int8_matmul_prepared, prepared), ("int8_matmul_cuda", int8_matmul_cuda, operands),
        ("_int_mm", int8_library, library_ops))]
    host = {label: min(us for name, us in turns if name == label) for label, _ in turns}
    kernel_only = sum(us for name, us, _ in kern if "int8_matmul_kernel" in name) / 5 / 1e3
    others = sorted({name for name, _, _ in kern if "int8_matmul_kernel" not in name})
    print_largest_products(product_times(int8_matmul_prepared, prepared), shapes)
    bytes_moved = sum(int8_bytes_ops(*shape)[0] for shape in shapes)
    n_ops = sum(int8_bytes_ops(*shape)[1] for shape in shapes)
    bound_ms, bound_by = bound(bytes_moved, n_ops, PEAK_INT8_OPS_PER_S)
    print(f"int8_matmul over the {len(shapes)} products of one forward (batch 4, {IMGSZ} px; exact at each, float32 "
          f"and bfloat16 out): kernel {ms:.4f} ms on the device per forward, {call_ms:.3f} ms host to host (events); "
          f"plain {plain_ms:.4f} ms on the device, {plain_call_ms:.3f} ms host to host; torch._int_mm + "
          f"dequantization {lib_ms:.4f} ms on the device, {lib_call_ms:.3f} ms host to host; bound {bound_ms:.4f} ms "
          f"({bound_by}: {bytes_moved / 1e6:.1f} MB, {n_ops / 1e9:.2f} Gop)")
    print("  host time per call (the calls' own host time over 5 forwards, in turns): " + "; ".join(
        f"{label} {us:.2f} us" for label, us in turns) + " (prepared: the weight prepared once, as the conv path "
        "calls it; int8_matmul_cuda prepares it on every call; _int_mm: torch._int_mm + dequantization)")
    outside = (ms - kernel_only) / ms
    print(f"  device time outside int8_matmul_kernel: {outside:.4f} of {ms:.4f} ms (must be 0); other device "
          f"items: {others or 'none'}")
    if others:
        raise SystemExit(f"the int8 matmul wrapper ran device work besides its kernel: {others}")
    del operands, prepared, library_ops
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by, call_ms=call_ms,
                plain_call_ms=plain_call_ms, host_us_per_call=host["prepared"],
                shape=f"the {len(shapes)} products of one forward, batch 4, {IMGSZ} px")


def check_int8_convs_against_cpu(dev, host, model, frames):
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
            host.model(torch.stack([letterbox(f, (IMGSZ, IMGSZ), "cpu") for f in frames]).float() / 255.0)
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
                            lambda f: box_best(f, spec.head_strides, spec.nc, spec.reg_max), feats,
                            counter=lambda: kernels.launch_counts()["decode_box_best"])
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
                            counter=lambda: kernels.launch_counts()["decode_xywh"])
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


def kernel_entry(name, source, replaces, launches, row, bf16_launches, bf16_head=None):
    """One entry of the kernels line; ``launches`` counts every path's run, ``bf16_launches`` those of
    phase 10's bf16 paths among them, ``bf16_head`` the kernel on a real forward's bf16 head."""
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
            "bf16_launches": bf16_launches, **({"bf16_head": bf16_head} if bf16_head else {}),
            "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": row.get("library_ms"),
            "shape": row["shape"], "call_ms": row["call_ms"], "plain_call_ms": row["plain_call_ms"],
            **({"host_us_per_call": row["host_us_per_call"]} if "host_us_per_call" in row else {}),
            **({"two_byte_levels": row["two_byte_levels"]} if "two_byte_levels" in row else {})}


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
    bf16 = {k: half_launches[k] + half_xywh_launches[k] + half_int8_launches[k] + amp_launches[k]
            for k in half_launches}
    kernels_line = {"kernels": [
        kernel_entry("decode_box_best", "bsyolo_tpu_torch/kernels/csrc/decode.cu", "bsyolo_tpu/kernels/decode.py:124",
                     predict_launches["decode_box_best"] + val_launches["decode_box_best"]
                     + trainer_launches["decode_box_best"] + bf16["decode_box_best"], box_row,
                     bf16["decode_box_best"], box_half),
        kernel_entry("decode_xywh", "bsyolo_tpu_torch/kernels/csrc/decode.cu",
                     "bsyolo_tpu/kernels/decode.py:34",
                     tta_launches["decode_xywh"] + tiled_launches["decode_xywh"] + bf16["decode_xywh"], xywh_row,
                     bf16["decode_xywh"], xywh_half),
        kernel_entry("int8_matmul", "bsyolo_tpu_torch/kernels/csrc/int8_matmul.cu",
                     "bsyolo_tpu/kernels/int8_matmul.py:38", int8_launches["int8_matmul"] + bf16["int8_matmul"],
                     dict(max_abs_err=int8_err, **int8_row), bf16["int8_matmul"]),
    ]}
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
