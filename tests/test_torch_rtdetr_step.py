"""One AdamW train step of the tiny RT-DETR graph (tests/rtdetr_port.py) with the labels fed into the graph
(``pass_targets``), in the PyTorch port against bsyolo_tpu: the same weights, batch and denoising draws
(JAX's, recorded as it makes them). Loss items within 2e-3; parameters, EMA and BatchNorm statistics at
tests/test_torch_train_step.py's gates (rtol 1e-4 / atol 1e-6; under AdamW at most 1e-3 of the elements
past it, each within 2 lr). The optimizer slots (Adam's m and v, the clipped gradient's first and
second moments) are held against a float64 referee instead of each other: the deformable sampling's
gradient in float32 is itself 1.7e-3 (norm-relative, sampling offsets) from the same graph's float64
gradient, and the backbone's 1e-3, so the two float32 packages sit up to twice that apart; each
package's slots, tensor by tensor, within SLOT_RTOL of the float64 graph's."""

import copy
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent))

import jax
import jax.numpy as jnp
import torch

from rtdetr_port import label_batch, spy_cdn_draws, tiny_models, use_draws
from torch_port import nchw, to_plain_dict

SLOT_RTOL = 1e-2  # norm-relative, per tensor with a gradient; measured: the port 1.7e-3, JAX under 5e-3


def _float64_slots(model, batch, beta1: float, max_norm: float = 10.0):
    """Adam's m and v after one step of ``model`` run in float64 (a copy), by name."""
    from bsyolo_tpu_torch.losses.detr import rtdetr_loss
    from bsyolo_tpu_torch.ops.normalize import normalize_image_batch

    m64 = copy.deepcopy(model).double().train()
    out = m64(normalize_image_batch(batch["img"]).double(), targets={k: batch[k] for k in ("cls", "bboxes", "mask")})
    rtdetr_loss(out, batch["cls"], batch["bboxes"], batch["mask"])[0].backward()
    g = {n: p.grad for n, p in m64.named_parameters()}
    scale = min(1.0, max_norm / (float(torch.linalg.vector_norm(torch.stack([t.norm() for t in g.values()]))) + 1e-6))
    return ({n: (1 - beta1) * scale * t for n, t in g.items()}, {n: 1e-3 * (scale * t) ** 2 for n, t in g.items()})


def test_train_step_matches_jax(monkeypatch):
    from bsyolo_tpu.engine.optim import OptimConfig as JOpt
    from bsyolo_tpu.engine.train_step import StepConfig as JStep, init_train_state as jinit, make_train_step as jmake
    from bsyolo_tpu.losses import DetectionLossConfig as JLoss
    from bsyolo_tpu.losses.detr import rtdetr_loss as jax_loss

    from bsyolo_tpu_torch.engine.optim import OptimConfig
    from bsyolo_tpu_torch.engine.train_step import StepConfig, init_train_state, make_train_step, task_criterion
    from bsyolo_tpu_torch.losses import DetectionLossConfig
    from bsyolo_tpu_torch.utils.weights import _from_torch_layout, flax_path_to_torch_key, train_state_to_jax

    jm, variables, port, spec = tiny_models(hw=(64, 64), seed=3)
    common = dict(batch_size=2, nb=5, nw=0, use_adamw=True, weight_decay=0.0005, pass_targets=True)
    okw = dict(name="AdamW", lr0=1e-4, epochs=4, nbs=2)
    jcfg = JStep(loss=JLoss(nc=4, strides=spec.head_strides), optim=JOpt(**okw), **common)
    jstep = jmake(jm, jcfg, criterion=lambda o, b, ls, lc: (*jax_loss(o, b["cls"], b["bboxes"], b["mask"]), ls),
                  item_names=("cls_loss", "bbox_loss", "giou_loss"))
    jstate = jinit({k: jax.tree_util.tree_map(jnp.asarray, v) for k, v in variables.items()}, jcfg)
    cls, bb, mask = label_batch(1, 2, 8, 4, n_valid=(2, 3))
    img = np.random.default_rng(4).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    captured = []
    spy_cdn_draws(monkeypatch, captured)
    jstate, jmetrics = jstep(jstate, {"img": jnp.asarray(img), "cls": cls, "bboxes": bb, "mask": mask})
    want = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), jstate)
    jax.effects_barrier()
    use_draws(monkeypatch, captured[0])
    batch = {"img": torch.from_numpy(nchw(img)), "cls": torch.from_numpy(cls).long(), "bboxes": torch.from_numpy(bb),
             "mask": torch.from_numpy(mask)}
    pcfg = StepConfig(loss=DetectionLossConfig(nc=4, strides=spec.head_strides), optim=OptimConfig(**okw), **common)
    ref_m, ref_v = _float64_slots(port, batch, pcfg.optim.momentum)
    pstate = init_train_state(port, pcfg)
    pstate, pmetrics = make_train_step(port, pcfg, *task_criterion(spec))(pstate, batch)
    for k in ("loss", "cls_loss", "bbox_loss", "giou_loss"):
        np.testing.assert_allclose(float(pmetrics[k]), float(jmetrics[k]), rtol=2e-3, err_msg=k)
    got = train_state_to_jax(pstate, want)
    assert (got["step"], got["ema_updates"], got["last_opt_step"]) == (1, int(want.ema_updates), 0)

    lr = max(pmetrics["lr"], 0.1)  # the bias group's warmup lr
    missed = total = 0
    for field in ("params", "ema_params", "batch_stats"):
        flat = dict(jax.tree_util.tree_flatten_with_path(to_plain_dict(getattr(want, field)))[0])
        for path, g in jax.tree_util.tree_flatten_with_path(got[field])[0]:
            x = np.asarray(flat[path])
            if field == "batch_stats":
                np.testing.assert_allclose(g, x, rtol=1e-4, atol=1e-6, err_msg=jax.tree_util.keystr(path))
                continue
            miss = ~np.isclose(g, x, rtol=1e-4, atol=1e-6)
            assert (np.abs(g - x)[miss] <= 2 * lr).all(), jax.tree_util.keystr(path)
            missed, total = missed + int(miss.sum()), total + x.size
    print(f"AdamW step: {missed} of {total} parameter and EMA elements past rtol 1e-4 (each within 2 lr)")
    assert missed <= 1e-3 * total

    for field, ref in (("slot0", ref_m), ("slot1", ref_v)):
        flat = dict(jax.tree_util.tree_flatten_with_path(to_plain_dict(getattr(want, field)))[0])
        floor = 1e-6 * max(float(t.norm()) for t in ref.values())
        worst = {"port": 0.0, "jax": 0.0}
        for path, g in jax.tree_util.tree_flatten_with_path(got[field])[0]:
            keys = tuple(p.key for p in path)
            r = _from_torch_layout(ref[flax_path_to_torch_key("params", keys)].numpy(), keys[-1])
            if np.linalg.norm(r) <= floor:  # an analytic zero (a bias before BatchNorm)
                continue
            for who, t in (("port", g), ("jax", np.asarray(flat[path]))):
                worst[who] = max(worst[who], float(np.linalg.norm(t - r) / np.linalg.norm(r)))
        print(f"{field} against the float64 graph's, worst tensor: {worst}")
        assert worst["port"] <= SLOT_RTOL and worst["jax"] <= SLOT_RTOL, (field, worst)
