#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bsyolo_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (PATH or $CUDA_HOME/bin) and this checkout; exits
non-zero without them. Phases, each of which fails the run on its own:

1. the card's name and power limit; every kernel of the port built with
   nvcc from ``bsyolo_tpu_torch/kernels/csrc``, one nvcc per source, all at once;
2. each kernel against its plain PyTorch version on the card, at the predict
   path's shapes and at a ragged one, with its time, the plain version's time
   and the least time the card could take (bytes or operations over the
   card's published peak);
3. the predict path at full yolo11n width (nc 12, imgsz 640), seeded random
   weights, 8 seeded synthetic frames (480x640 and 720x1280), batch 1 and
   batch 4, conf 0.001: every kernel of the path launched, throughput,
   and detections held against the same port on the CPU.

TF32 is off for convolutions and matrix products throughout, so the card and
the CPU compute the same float32 function (cuDNN would otherwise run float32
convolutions in TF32). The last two lines are the kernels JSON and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import hashlib
import json
import math
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

BOX_ATOL_PX = 2e-3  # kernel vs plain: float32 softmax sums in another order, times strides up to 32
SEED = 0
IMGSZ = 640
CONF = 0.001
N_FRAMES = 8
HEAD_GAIN = 25.0  # scales the head's last convs so random weights give spread logits, as a trained head has
# card vs CPU detections: near-tied scores may swap rows or cross the max_det/NMS boundaries under float
# rounding of other convolution algorithms, so rows are matched, not compared in order
MATCH_BOX_PX, MATCH_SCORE, MATCH_MIN_FRACTION = 0.05, 1e-4, 0.98


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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
        for line in rec["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    print(f"build wall time {time.perf_counter() - t0:.2f} s")


def device_kernels(prof):
    """(name, device us summed, calls) of every device-side event in a profile."""
    from torch.autograd import DeviceType

    return [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def cuda_time_ms(fn, inputs, reps: int):
    """Mean ms per call of ``fn(*inputs[i % len(inputs)])`` after warm-up: CUDA events
    around the loop (host enqueue included where it is the slower side), and the
    device time of every kernel the calls launched, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for i in range(3):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / reps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(*inputs[i % len(inputs)])
        torch.cuda.synchronize()
    device_ms = sum(us for _, us, _ in device_kernels(prof)) / reps / 1e3
    return event_ms, device_ms


def check_decode_kernel(dev):
    """box_best_cuda against box_best_reference on the card; returns the kernels-line fields."""
    import torch

    from bsyolo_tpu_torch.kernels.decode import REG_MAX, box_best_cuda, box_best_reference
    from bsyolo_tpu_torch.ops.anchors import make_anchors

    g = torch.Generator(device=dev).manual_seed(SEED)
    worst, rows = 0.0, {}
    for b, side, nc in ((1, IMGSZ, 12), (4, IMGSZ, 12), (8, IMGSZ, 12), (2, 224, 80)):
        shapes = [(side // s, side // s) for s in (8, 16, 32)]
        anchors, strides = make_anchors(shapes, (8, 16, 32), 0.5, device=dev)
        a, no = anchors.shape[0], 4 * REG_MAX + nc
        head = torch.randn((b, no, a), generator=g, device=dev) * 2.0
        head[0, REG_MAX : 2 * REG_MAX] -= 120.0  # one side far below the others (NaN for a single row max)
        boxes, best = box_best_cuda(head, anchors, strides, nc)
        want_boxes, want_best = box_best_reference(head, anchors, strides, nc)
        torch.cuda.synchronize()
        err = (boxes - want_boxes).abs().max().item()
        best_err = (best - want_best).abs().max().item()
        finite = bool(torch.isfinite(boxes).all())
        ok = finite and err <= BOX_ATOL_PX and best_err == 0.0
        # time on copies that together exceed the 50 MB L2, so each launch reads its head from HBM
        copies = [(head.clone(), anchors, strides, nc) for _ in range(max(2, math.ceil(120e6 / head.nbytes)))]
        call_ms, dev_ms = cuda_time_ms(box_best_cuda, copies, 200)
        plain_call_ms, plain_dev_ms = cuda_time_ms(box_best_reference, copies, 50)
        # device time where the profiler sees the kernels, else the events' per-call time
        ms, plain_ms = dev_ms or call_ms, plain_dev_ms or plain_call_ms
        bytes_moved = head.nbytes + anchors.nbytes + strides.nbytes + b * a * (4 + 1) * 4
        ops = b * a * (4 * (6 * REG_MAX + 1) + nc + 8)  # per side: max, sub, exp, add, fma (2); one divide
        bound_ms = max(bytes_moved / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S) * 1e3
        bound_by = "bytes" if bytes_moved / PEAK_BYTES_PER_S >= ops / PEAK_F32_OPS_PER_S else "operations"
        print(f"decode_box_best B={b} A={a} nc={nc}: max|box err| {err:.3g} px (tol {BOX_ATOL_PX}), "
              f"max|best err| {best_err:.3g} (tol 0), finite {finite}; {'OK' if ok else 'FAIL'}\n"
              f"  kernel {dev_ms * 1e3:.2f} us on the device, {call_ms * 1e3:.2f} us per call (events); "
              f"plain {plain_dev_ms * 1e3:.2f} us on the device, {plain_call_ms * 1e3:.2f} us per call; "
              f"bound {bound_ms * 1e3:.2f} us ({bound_by}: {bytes_moved / 1e6:.2f} MB, {ops / 1e6:.1f} Mop)")
        if not ok:
            raise SystemExit(f"decode_box_best disagrees with its plain version at B={b} A={a} nc={nc}")
        worst = max(worst, err)
        rows[(b, nc)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, call_ms=call_ms,
                             plain_call_ms=plain_call_ms, shape=f"B{b} A{a} nc{nc}")
    # the kernels line reports the largest batch the predict phase runs
    return dict(max_abs_err=worst, **rows[(4, 12)])


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


def match_detections(got: np.ndarray, want: np.ndarray):
    """Greedy match of each ``want`` row to the nearest unused ``got`` row of the
    same class, distance max(|box diff| / MATCH_BOX_PX, |score diff| / MATCH_SCORE),
    accepted at distance <= 1; returns the (box err, score err) of every matched pair."""
    used = np.zeros(len(got), bool)
    errs = []
    for row in want:
        cand = np.flatnonzero(~used & (got[:, 5] == row[5]))
        if not len(cand):
            continue
        box = np.abs(got[cand, :4] - row[:4]).max(1)
        score = np.abs(got[cand, 4] - row[4])
        dist = np.maximum(box / MATCH_BOX_PX, score / MATCH_SCORE)
        k = int(np.argmin(dist))
        if dist[k] <= 1.0:
            used[cand[k]] = True
            errs.append((float(box[k]), float(score[k])))
    return errs


def predict_path(dev):
    import torch

    from bsyolo_tpu_torch import YOLO, kernels
    from bsyolo_tpu_torch.nn.heads import flatten_levels
    from bsyolo_tpu_torch.ops.letterbox import letterbox

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
    launches = kernels.launch_counts()
    expected = sum(math.ceil(N_FRAMES / b) for b in runs)
    print(f"kernel launches in the predict runs: {launches} (batches: {expected})")
    for name, n in launches.items():
        if n != expected:
            raise SystemExit(f"kernel {name} launched {n} times on the predict path, expected {expected}")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.predict(frames[:4], imgsz=IMGSZ, batch=4, conf=CONF)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = sorted(device_kernels(prof), key=lambda k: -k[1])
    busy_ms = sum(us for _, us, _ in kern) / 1e3
    print(f"one batch of 4 under torch.profiler: {wall_ms:.1f} ms wall, {busy_ms:.2f} ms of device work; device busy "
          f"{busy_ms / wall_ms:.3f} of the profiled wall time, {busy_ms / batch_ms[4]:.3f} of the unprofiled "
          f"{batch_ms[4]:.1f} ms per batch; largest device items:")
    for name, us, n in kern[:10]:
        print(f"  {us / 1e3:8.3f} ms  {n:5d} x  {name[:100]}")

    # host-clock split of one batch of 4, synchronised after each stage; median of 5
    from bsyolo_tpu_torch.kernels.postprocess import detect_postprocess

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
        for i, d in enumerate(dets):
            if not (d.ndim == 2 and d.shape[1] == 6 and len(d) > 0 and np.isfinite(d).all()):
                raise SystemExit(f"batch {batch}, frame {i}: detections are not finite (n, 6) rows: {d.shape}")
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
    cpu_res = host.predict(frames, imgsz=IMGSZ, batch=4, conf=CONF)
    for label, dets in (("batch 1", runs[1]), ("batch 4", runs[4])):
        n_want = n_got = same_frames = 0
        errs = []
        for g_, r in zip(dets, cpu_res):
            w = r.boxes.data
            e = match_detections(g_, w)
            n_want, n_got, errs = n_want + len(w), n_got + len(g_), errs + e
            same_frames += len(e) == len(w) == len(g_)
        frac = len(errs) / max(n_want, n_got)
        box_q = np.quantile([e[0] for e in errs], [0.5, 0.99, 1.0])
        score_q = np.quantile([e[1] for e in errs], [0.5, 0.99, 1.0])
        print(f"detections card ({label}) vs CPU: {n_got} vs {n_want} rows, {len(errs)} matched ({frac:.4f}; "
              f"same class, |box| <= {MATCH_BOX_PX} px, |score| <= {MATCH_SCORE}); {same_frames} of {N_FRAMES} "
              f"frames match in every row; matched |box err| px p50/p99/max {box_q[0]:.3g}/{box_q[1]:.3g}/"
              f"{box_q[2]:.3g}, |score err| {score_q[0]:.3g}/{score_q[1]:.3g}/{score_q[2]:.3g}")
        if frac < MATCH_MIN_FRACTION:
            raise SystemExit(f"card detections ({label}) match the CPU's in {frac:.4f} of rows, "
                             f"below {MATCH_MIN_FRACTION}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available; this script runs only on one", file=sys.stderr)
        return 1
    from bsyolo_tpu_torch import select_device

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = select_device(None)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, TF32 off")
    build_kernels()
    decode_row = check_decode_kernel(dev)
    launches = predict_path(dev)
    kernels_line = {"kernels": [{
        "name": "decode_box_best", "route": "cuda", "source": "bsyolo_tpu_torch/kernels/csrc/decode_box.cu",
        "replaces": "bsyolo_tpu/kernels/decode.py:124", "launches": launches["decode_box_best"],
        "max_abs_err": decode_row["max_abs_err"], "ms": decode_row["ms"], "plain_ms": decode_row["plain_ms"],
        "bound_ms": decode_row["bound_ms"], "bound_by": decode_row["bound_by"], "library_ms": None,
        "shape": decode_row["shape"], "call_ms": decode_row["call_ms"], "plain_call_ms": decode_row["plain_call_ms"],
    }]}
    print(card)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
