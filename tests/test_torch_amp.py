"""The port's bf16 training paths against bsyolo_tpu: ``task_aligned_assign(bf16=True)``
(``assigner_bf16``) and the amp train step (the JAX trainer's ``amp=True`` default: the
train step over a ``dtype=bfloat16`` graph with float32 parameters).

Assigner: seeded inputs without near-ties give identical ``fg_mask``, target indices,
labels and boxes, and target scores within ``SCORE_ATOL`` (half a bfloat16 step at 1.0:
the normalisation's bfloat16 quotient may round the other way); metrics tied only in
bfloat16 keep the same anchors in both packages. ``detection_loss(assigner_bf16=True)``
within ``BF16_LOSS_RTOL`` of JAX's.

Amp step: tests/fixtures/tiny.yaml at 64 px, batch 2, the seeded weights and batches of
tests/test_torch_train_step.py, two steps, SGD and AdamW (each AdamW step from the JAX
state before it). The port rounds every op to bfloat16 while XLA keeps some intermediates
in float32, and train-mode BatchNorm over 4 x 4 and 8 x 8 maps at batch 2 amplifies
rounding: JAX's own bfloat16 head maps are 3.4e-2 and 6.2e-2 (norm-relative) away from its
float32 maps on this batch, the port's 3.5e-2 and 7.9e-2. So the gates are stated against
what was measured (each test prints its figures): loss items within ``AMP_LOSS_RTOL``;
parameters and EMA within ``AMP_PARAM_NORM`` of their norm; BatchNorm statistics float32
and each within ``AMP_BN_NORM`` of its norm.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import jax
import jax.numpy as jnp
import torch

from test_torch_loss import _assign_inputs, _loss_inputs
from test_torch_train_step import ADAM_NOISY, B, IMG, _batch, _port_batch, _port_model
from torch_port import nchw, random_variables, to_plain_dict, variable_shapes

SCORE_ATOL = 2.0**-8
BF16_LOSS_RTOL = 2e-3
# amp step gates, each beside what was measured on this fixture (this host's CPU)
AMP_LOSS_RTOL = 5e-2  # loss items: at most 2.9e-2 (box, AdamW's second step)
AMP_PARAM_NORM = 2e-3  # SGD params and EMA: 2.9e-4 and 6.3e-4 of their norm
AMP_UPDATE_NORM = 0.2  # SGD's update (params - start): 3.1e-2 and 9.6e-2 of its norm
AMP_ADAM_NORM = 5e-2  # AdamW params and EMA: 3.4e-2 and 1.6e-2, nearly all from moves of +-lr apart
AMP_BN_NORM = 2e-3  # BatchNorm statistics: 5.9e-4 to 1.1e-3 of their norm


# --- assigner_bf16 -----------------------------------------------------------------------------


def _assign_both(inputs, topk, nc=4, bf16=True):
    from bsyolo_tpu.losses.tal import task_aligned_assign as jassign
    from bsyolo_tpu_torch.losses.tal import task_aligned_assign

    want = jassign(*[jnp.asarray(x) for x in inputs], topk=topk, num_classes=nc, bf16=bf16)
    got = task_aligned_assign(*[torch.from_numpy(np.asarray(x)) for x in inputs], topk=topk, num_classes=nc,
                              bf16=bf16)
    return got, want


def _assert_same_assignment(got, want):
    np.testing.assert_array_equal(got.fg_mask.numpy(), np.asarray(want.fg_mask))
    np.testing.assert_array_equal(got.target_gt_idx.numpy(), np.asarray(want.target_gt_idx))
    np.testing.assert_array_equal(got.target_labels.numpy(), np.asarray(want.target_labels))
    np.testing.assert_array_equal(got.target_bboxes.numpy(), np.asarray(want.target_bboxes))  # float32 inputs
    assert got.target_scores.dtype == torch.float32
    np.testing.assert_allclose(got.target_scores.numpy(), np.asarray(want.target_scores), rtol=0, atol=SCORE_ATOL)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("topk", [1, 3, 10])
def test_bf16_assigner_matches_jax(seed, topk):
    got, want = _assign_both(_assign_inputs(seed), topk)
    fg = got.fg_mask.numpy()
    assert fg[:-1].any() and not fg[-1].any()
    _assert_same_assignment(got, want)


def test_bf16_assigner_runs_in_bf16():
    """Across the seeded cases the bf16 ranking selects other anchors than float32 somewhere,
    and keeps the float32 inputs' boxes where it agrees."""
    flips = 0
    for seed in range(4):
        for topk in (1, 3, 10):
            got, _ = _assign_both(_assign_inputs(seed), topk)
            f32, _ = _assign_both(_assign_inputs(seed), topk, bf16=False)
            flips += int((got.fg_mask != f32.fg_mask).sum())
    assert flips > 0


def test_bf16_assigner_keeps_every_anchor_tied_in_bf16():
    """Scores that differ below bfloat16's resolution tie in the bf16 metric: both packages
    keep every tied anchor, where float32 ranks them apart and keeps k."""
    scores, pd_bboxes, anc, labels, gt, mask = _assign_inputs(7, b=2)
    gt[0, 0] = [30, 30, 90, 90]
    pd_bboxes[0] = [40, 40, 80, 80]  # every anchor predicts the same box
    scores[0] = 0.6 + np.random.default_rng(1).uniform(0, 1e-4, scores[0].shape).astype(np.float32)
    inputs = (scores, pd_bboxes, anc, labels, gt, mask)
    got, want = _assign_both(inputs, 3)
    _assert_same_assignment(got, want)
    only0 = got.target_gt_idx[0] == 0
    f32, _ = _assign_both(inputs, 3, bf16=False)
    kept16, kept32 = int((got.fg_mask[0] & only0).sum()), int((f32.fg_mask[0] & (f32.target_gt_idx[0] == 0)).sum())
    assert kept16 > 3 and kept32 <= 3, (kept16, kept32)


def test_detection_loss_with_bf16_assigner_matches_jax():
    from bsyolo_tpu.losses.detect import DetectionLossConfig as JCfg, detection_loss as jloss, init_loss_state as jinit
    from bsyolo_tpu_torch.losses.detect import DetectionLossConfig, detection_loss, init_loss_state

    from test_torch_loss import NC, STRIDES

    for seed in (400, 401):
        levels, cls, boxes, mask = _loss_inputs(seed)
        wt, wi, _ = jloss([jnp.asarray(f) for f in levels], jnp.asarray(cls), jnp.asarray(boxes), jnp.asarray(mask),
                          jinit(), JCfg(nc=NC, strides=STRIDES, assigner_bf16=True))
        gt, gi, _ = detection_loss([torch.from_numpy(nchw(f)) for f in levels], torch.from_numpy(cls),
                                   torch.from_numpy(boxes), torch.from_numpy(mask), init_loss_state(),
                                   DetectionLossConfig(nc=NC, strides=STRIDES, assigner_bf16=True))
        np.testing.assert_allclose(gt.item(), float(wt), rtol=BF16_LOSS_RTOL)
        np.testing.assert_allclose(gi.numpy(), np.asarray(wi), rtol=BF16_LOSS_RTOL)


# --- the amp train step ------------------------------------------------------------------------

AMP_CASES = {"sgd": dict(name="SGD", use_adamw=False), "adamw": dict(name="AdamW", use_adamw=True)}


def _norm_rel(got, want, start=None):
    """||got - want|| over ||want|| (over ||want - start|| with ``start``), float64, over two trees."""
    g = [np.asarray(x, np.float64) for x in jax.tree_util.tree_leaves(got)]
    w = [np.asarray(x, np.float64) for x in jax.tree_util.tree_leaves(to_plain_dict(want))]
    s = [np.asarray(x, np.float64) for x in jax.tree_util.tree_leaves(start)] if start is not None else [0.0] * len(w)
    return (sum(((a - b) ** 2).sum() for a, b in zip(g, w)) / sum(((b - c) ** 2).sum() for b, c in zip(w, s))) ** 0.5


@pytest.fixture(scope="module", params=list(AMP_CASES))
def amp_runs(request):
    """Two amp steps of each package from the same weights and batches: (case, per step: port
    state as JAX trees, JAX state, port metrics, JAX metrics, port BatchNorm buffers, the
    parameters before the step, the dtypes of the port's head levels)."""
    from bsyolo_tpu.engine.optim import OptimConfig as JOpt
    from bsyolo_tpu.engine.train_step import StepConfig as JStep, init_train_state as jinit, make_train_step as jmake
    from bsyolo_tpu.losses import DetectionLossConfig as JLoss
    from bsyolo_tpu.nn import load_model_yaml, parse_model_yaml
    from bsyolo_tpu.nn.model import DetectionGraph
    from bsyolo_tpu_torch.engine.optim import OptimConfig
    from bsyolo_tpu_torch.engine.train_step import StepConfig, init_train_state, make_train_step
    from bsyolo_tpu_torch.losses import DetectionLossConfig
    from bsyolo_tpu_torch.nn.model import set_compute_dtype
    from bsyolo_tpu_torch.utils.weights import train_state_from_jax, train_state_to_jax

    from test_torch_train_step import TINY

    case = AMP_CASES[request.param]
    spec = parse_model_yaml(load_model_yaml(TINY))
    variables = to_plain_dict(random_variables(variable_shapes(DetectionGraph(spec), (1, IMG, IMG, 3)), seed=5))
    model = DetectionGraph(spec, dtype=jnp.bfloat16)  # the JAX trainer's graph under amp
    common = dict(batch_size=B, nb=5, nw=2, use_adamw=case["use_adamw"], weight_decay=0.0005)
    okw = dict(name=case["name"], lr0=0.01, epochs=4, nbs=B, warmup_bias_lr=0.1)
    jcfg = JStep(loss=JLoss(nc=spec.nc, strides=spec.head_strides), optim=JOpt(**okw), **common)
    jstep = jmake(model, jcfg)
    jstate = jinit({k: jax.tree_util.tree_map(jnp.asarray, v) for k, v in variables.items()}, jcfg)
    port = set_compute_dtype(_port_model(variables), torch.bfloat16)
    head_dtypes = set()
    port.model[-1].register_forward_hook(lambda m, a, levels: head_dtypes.update(f.dtype for f in levels))
    pcfg = StepConfig(loss=DetectionLossConfig(nc=spec.nc, strides=spec.head_strides), optim=OptimConfig(**okw),
                      **common)
    pstate, pstep = init_train_state(port, pcfg), make_train_step(port, pcfg)
    out, start = [], variables
    for i in range(2):
        batch = _batch(20 + i)
        if case["use_adamw"] and i:
            pstate = train_state_from_jax(out[-1][1], port)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        want = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), jstate)  # the next step donates jstate
        pstate, pm = pstep(pstate, _port_batch(batch))
        out.append((train_state_to_jax(pstate, want), want, pm, {k: np.asarray(v) for k, v in jm.items()},
                    dict(pstate.batch_stats), start, set(head_dtypes)))
        start = {"params": to_plain_dict(want.params), "batch_stats": to_plain_dict(want.batch_stats)}
    return case, out


@pytest.mark.parametrize("after", [1, 2])
def test_amp_train_step_matches_jax(amp_runs, after):
    case, out = amp_runs
    got, want, pm, jm, bn, start, head_dtypes = out[after - 1]
    items = max(abs(float(pm[k]) - float(jm[k])) / abs(float(jm[k])) for k in ("box_loss", "cls_loss", "dfl_loss"))
    params, ema = _norm_rel(got["params"], want.params), _norm_rel(got["ema_params"], want.ema_params)
    update = _norm_rel(got["params"], want.params, start["params"])
    stats = _norm_rel(got["batch_stats"], want.batch_stats)
    lr = max(float(pm["lr"]), 0.1)
    flips = total = 0
    worst = 0.0
    for field in ("params", "ema_params"):
        for g, w in zip(jax.tree_util.tree_leaves(got[field]),
                        jax.tree_util.tree_leaves(to_plain_dict(getattr(want, field)))):
            d = np.abs(g - np.asarray(w))
            flips, total, worst = flips + int((d > 0.5 * lr).sum()), total + d.size, max(worst, float(d.max()))
    print(f"amp {case['name']} after {after} step(s): loss items max rel {items:.3g}; params {params:.3g}, EMA "
          f"{ema:.3g} of their norm; the update {update:.3g} of its norm; BatchNorm statistics {stats:.3g}; "
          f"{flips} of {total} parameter and EMA elements apart by more than lr / 2, largest {worst:.3g}")
    assert head_dtypes == {torch.bfloat16}
    assert all(b.dtype == torch.float32 for b in bn.values())
    assert items <= AMP_LOSS_RTOL
    assert stats <= AMP_BN_NORM
    assert int(pm["updated"]) == int(jm["updated"]) == 1
    if case["use_adamw"]:  # Adam's near-sign moves: see ADAM_NOISY in tests/test_torch_train_step.py
        assert params <= AMP_ADAM_NORM and ema <= AMP_ADAM_NORM
        assert worst <= 2 * lr and flips <= ADAM_NOISY * total
    else:
        assert params <= AMP_PARAM_NORM and ema <= AMP_PARAM_NORM and update <= AMP_UPDATE_NORM


@pytest.mark.slow
def test_amp_training_trajectory_matches_jax(tmp_path):
    """The 24-epoch leg of docs/training_parity.md (tiny.yaml at 96 px, 48 train / 16 val synthetic
    images, augmentation off, SGD lr0 0.02, batch 8) with amp=True on both sides: the port's final
    mAP50 within 0.15 of the JAX trainer's."""
    from test_e2e_train import make_synthetic_dataset
    from test_train_parity import AUG_OFF, HYP

    from bsyolo_tpu.engine.trainer import DetectionTrainer as JaxTrainer

    from bsyolo_tpu_torch.engine.trainer import DetectionTrainer
    from test_torch_train_step import TINY

    data = make_synthetic_dataset(tmp_path / "ds", n_train=48, n_val=16, size=96)
    final = {}
    for name, cls, extra in (("jax", JaxTrainer, {}), ("port", DetectionTrainer, {"device": "cpu"})):
        tr = cls(overrides={"model": TINY, "data": str(data), "epochs": 24, "batch": 8, "imgsz": 96,
                            "optimizer": "SGD", "seed": 3, "max_gt": 32, "amp": True, "close_mosaic": 0,
                            "plots": False, "workers": 0, "project": str(tmp_path / "runs"), "name": name,
                            **HYP, **AUG_OFF, **extra})
        tr.add_callback("on_train_start", lambda t: t.train_loader.dataset.hyp.update(albumentations=0.0))
        final[name] = float(tr.train().box.map50)
    print(f"final mAP50 under amp: {final}")
    assert abs(final["port"] - final["jax"]) <= 0.15, final


@pytest.mark.slow
def test_amp_gradient_noise_matches_jax():
    """yolo11n at 128 px, batch 2, the seeded variance-keeping weights: the amp gradient's distance from
    the float64 graph's gradient, for the port and for the JAX package's bf16 graph. Rounding to bf16,
    carried through train-mode BatchNorm over the whole depth, moves both far from float64; the port's
    amp gradient is held to be no farther than 1.5 times JAX's, and its float32 gradient to 1e-3."""
    from bsyolo_tpu.losses import DetectionLossConfig as JCfg, detection_loss as jloss, init_loss_state as jinit
    from bsyolo_tpu.nn.model import DetectionGraph
    from bsyolo_tpu_torch.losses import DetectionLossConfig, detection_loss, init_loss_state
    from bsyolo_tpu_torch.nn.model import build_model, set_compute_dtype
    from bsyolo_tpu_torch.utils.weights import state_dict_from_jax

    from torch_port import jax_spec, port_module_from_jax, port_spec

    size = 128
    spec = jax_spec("yolo11n.yaml")
    variables = to_plain_dict(random_variables(variable_shapes(DetectionGraph(spec), (1, size, size, 3)), seed=1))
    batch = _batch(30, b=2, size=size)  # classes 0 and 1 of the 12
    x = batch["img"].astype(np.float32) / 255.0
    cfg = dict(nc=12, strides=spec.head_strides)

    def jax_grad(dtype):
        model = DetectionGraph(spec, dtype=dtype)

        def loss(params):
            out, _ = model.apply({"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
            return jloss(out, *(jnp.asarray(batch[k]) for k in ("cls", "bboxes", "mask")), jinit(), JCfg(**cfg))[0]

        g = jax.jit(jax.grad(loss))(variables["params"])
        tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), to_plain_dict(g))
        return {k: v.double() for k, v in state_dict_from_jax({"params": tree}).items()}

    def port_grad(dtype):
        model = port_module_from_jax(build_model(port_spec("yolo11n.yaml"), "cpu"), variables).train()
        if dtype == torch.float64:
            model = model.double()
        else:
            set_compute_dtype(model, dtype)
        xt = torch.from_numpy(nchw(x)).to(torch.float64 if dtype == torch.float64 else torch.float32)
        total, _, _ = detection_loss(model(xt), *(torch.from_numpy(batch[k]) for k in ("cls", "bboxes", "mask")),
                                     init_loss_state(), DetectionLossConfig(**cfg))
        total.backward()
        return {n: p.grad.double() for n, p in model.named_parameters()}

    ref = port_grad(torch.float64)

    def away(g):
        return (sum((g[k] - v).square().sum() for k, v in ref.items()) / sum(v.square().sum() for v in ref.values())).sqrt().item()

    port16, port32, jax16, jax32 = (away(port_grad(torch.bfloat16)), away(port_grad(torch.float32)),
                                    away(jax_grad(jnp.bfloat16)), away(jax_grad(jnp.float32)))
    print(f"gradients from the float64 graph's, of its norm: port bf16 {port16:.3g}, JAX bf16 {jax16:.3g}, port float32 "
          f"{port32:.3g}, JAX float32 {jax32:.3g}")
    assert port32 <= 1e-3 and jax32 <= 1e-3
    assert port16 <= 1.5 * jax16
