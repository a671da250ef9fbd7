"""The port's train mode, optimizer and train step (nn.modules.BatchNorm2d,
engine.optim, engine.train_step, utils.weights train-state carry-over)
against bsyolo_tpu.

tests/fixtures/tiny.yaml (C3k2_gai, SCDown, SPPF, ELA with GroupNorm, Detect;
nc 2) at imgsz 64, batch 2, M 4, the same seeded weights on both sides and
the same uint8 batches. Gates: train-mode head maps within rtol 1e-4; the
optimizer's schedule scalars and updates within rtol 1e-6; parameter-group
labels identical; after 1 and after 3 steps, params, EMA, BN statistics,
slot0 (and slot1 under AdamW), the accumulator and the counters within rtol
1e-4 / atol 1e-6 (each test prints the observed maximum), ``updated``
identical, for SGD with nbs > batch (one step that does not update) and a
frozen layer, and for AdamW.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import jax
import jax.numpy as jnp
import torch

from torch_port import nchw, nhwc, random_variables, to_plain_dict, variable_shapes

TINY = str(Path(__file__).parent / "fixtures" / "tiny.yaml")
IMG, B, M = 64, 2, 4


def _batch(seed, b=B, size=IMG, nc=2):
    """uint8 frames with 1 to 3 filled squares each (one grey level per class), padded labels."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 40, (b, size, size, 3), dtype=np.uint8)
    boxes = np.zeros((b, M, 4), np.float32)
    cls = np.zeros((b, M), np.int32)
    mask = np.zeros((b, M), np.float32)
    for i in range(b):
        for j in range(int(rng.integers(1, M))):
            w = int(rng.integers(10, 24))
            x0, y0 = (int(v) for v in rng.integers(2, size - w - 2, 2))
            c = int(rng.integers(0, nc))
            imgs[i, y0 : y0 + w, x0 : x0 + w] = 120 + 100 * c
            boxes[i, j] = [(x0 + w / 2) / size, (y0 + w / 2) / size, w / size, w / size]
            cls[i, j], mask[i, j] = c, 1.0
    return {"img": imgs, "cls": cls, "bboxes": boxes, "mask": mask}


def _port_batch(batch):
    return {k: torch.from_numpy(nchw(v) if k == "img" else v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, spec, seeded variables as numpy)."""
    from bsyolo_tpu.nn import load_model_yaml, parse_model_yaml
    from bsyolo_tpu.nn.model import DetectionGraph

    spec = parse_model_yaml(load_model_yaml(TINY))
    model = DetectionGraph(spec)
    variables = to_plain_dict(random_variables(variable_shapes(model, (1, IMG, IMG, 3)), seed=5))
    return model, spec, variables


def _port_model(variables):
    from bsyolo_tpu_torch.nn.model import DetectionGraph
    from bsyolo_tpu_torch.nn.parser import load_model_yaml, parse_model_yaml
    from bsyolo_tpu_torch.utils.weights import state_dict_from_jax

    model = DetectionGraph(parse_model_yaml(load_model_yaml(TINY)))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def _max_rel(got, want, atol=1e-6):
    """Largest |got - want| / (atol + |want|) over two nested trees."""
    if isinstance(want, dict):
        return max(_max_rel(got[k], want[k], atol) for k in want)
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(g - w) / (atol + np.abs(w))).max())


def _assert_tree_close(got, want, what, rtol=1e-4, atol=1e-6):
    if isinstance(want, dict):
        for k in want:
            _assert_tree_close(got[k], want[k], f"{what}/{k}", rtol, atol)
        return
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


# --- train-mode graph and BatchNorm ------------------------------------------


def test_train_mode_batchnorm_follows_flax():
    """One Conv + BN in train mode against the JAX ConvBN at a 4 x 4 map, batch 2
    (n = 32 per channel): output, running mean and running var (biased, as flax).
    Stock torch.nn.BatchNorm2d puts the unbiased variance into running_var and
    misses the gate by n / (n - 1)."""
    from bsyolo_tpu.nn.modules import ConvBN
    from bsyolo_tpu_torch.nn.modules import Conv

    rng = np.random.default_rng(9)
    x = rng.normal(0.3, 1.5, (2, 4, 4, 8)).astype(np.float32)
    jm = ConvBN(16, 3, 1)
    v = to_plain_dict(random_variables(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x))), 3))
    want, mutated = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    conv = Conv(8, 16, 3, 1)
    from bsyolo_tpu_torch.utils.weights import state_dict_from_jax

    conv.load_state_dict({k: t for k, t in state_dict_from_jax(v).items()}, strict=False)
    got = conv.train()(torch.from_numpy(nchw(x)))
    np.testing.assert_allclose(got.detach().numpy(), nchw(np.asarray(want)), rtol=1e-4, atol=1e-5)
    bs = mutated["batch_stats"]["bn"]
    np.testing.assert_allclose(conv.bn.running_mean.numpy(), np.asarray(bs["mean"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(conv.bn.running_var.numpy(), np.asarray(bs["var"]), rtol=1e-5, atol=1e-6)

    stock = torch.nn.BatchNorm2d(16, eps=1e-3, momentum=0.03)
    stock.load_state_dict({k: t for k, t in state_dict_from_jax(v).items() if k.startswith("bn.")} and
                          {k[3:]: t for k, t in state_dict_from_jax(v).items() if k.startswith("bn.")}, strict=False)
    stock.train()(conv.conv(torch.from_numpy(nchw(x))).detach())
    assert not np.allclose(stock.running_var.numpy(), np.asarray(bs["var"]), rtol=1e-5, atol=1e-6)


def test_graph_train_mode_matches_jax(tiny):
    """DetectionGraph in train mode: the same per-level maps and running statistics as
    the JAX graph's train apply, and a gradient reaches every parameter."""
    model, spec, variables = tiny
    x = _batch(1)["img"].astype(np.float32) / 255.0
    want, mutated = jax.jit(lambda v, x: model.apply(v, x, train=True, mutable=["batch_stats"]))(variables, x)
    port = _port_model(variables).train()
    got = port(torch.from_numpy(nchw(x)))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(nhwc(g.detach().numpy()), w, rtol=1e-4, atol=1e-4 * np.abs(w).max())
    from bsyolo_tpu_torch.utils.weights import state_dict_from_jax

    stats = state_dict_from_jax({"batch_stats": to_plain_dict(jax.tree_util.tree_map(np.asarray, mutated["batch_stats"]))})
    buffers = dict(port.named_buffers())
    assert len(stats) == sum(k.endswith(("running_mean", "running_var")) for k in buffers)
    for k, w in stats.items():
        np.testing.assert_allclose(buffers[k].numpy(), w.numpy(), rtol=1e-4, atol=1e-6, err_msg=k)
    sum(g.square().sum() for g in got).backward()
    missing = [n for n, p in port.named_parameters() if p.grad is None or not p.grad.abs().sum() > 0]
    assert not missing, f"no gradient reached {missing}"


def test_int8_mode_does_not_apply_in_train_mode(tiny):
    from bsyolo_tpu_torch.nn.modules import set_int8_inference

    _, _, variables = tiny
    x = torch.from_numpy(nchw(_batch(2)["img"])).float() / 255
    a = _port_model(variables).train()
    b = _port_model(variables).train()
    set_int8_inference(b, True)
    for g, w in zip(b(x), a(x)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# --- optimizer ---------------------------------------------------------------


def test_param_groups_match_jax(tiny):
    """Labels by name: bias -> 2, BatchNorm and GroupNorm weights -> 1, the rest (ELA's
    fusion weights included) -> 0."""
    from bsyolo_tpu.engine.optim import param_groups as jgroups
    from bsyolo_tpu_torch.engine.optim import param_groups
    from bsyolo_tpu_torch.utils.weights import flax_path_to_torch_key

    _, _, variables = tiny
    flat = jax.tree_util.tree_flatten_with_path(jgroups(variables["params"]))[0]
    want = {flax_path_to_torch_key("params", tuple(k.key for k in path)): int(v) for path, v in flat}
    got = param_groups(_port_model(variables))
    assert got == want
    assert got["model.7.gn.weight"] == 1 and got["model.7.ch_weight"] == 0 and got["model.0.bn.weight"] == 1


@pytest.mark.parametrize("cos", [False, True], ids=["linear", "cos"])
def test_schedule_scalars_match_jax(cos):
    from bsyolo_tpu.engine import optim as J
    from bsyolo_tpu_torch.engine import optim as P

    kw = dict(lr0=0.02, lrf=0.05, epochs=7, cos_lr=cos, warmup_bias_lr=0.1, nbs=64)
    jc, pc = J.OptimConfig(**kw), P.OptimConfig(**kw)
    jlf, plf = J.lr_lambda(jc), P.lr_lambda(pc)
    nw = 13
    for ni in (0, 1, 5, 12, 13, 14, 40):
        e = np.float32(ni) / np.float32(9)
        got = P.warmup_scalars(pc, ni, nw, e, plf)
        want = J.warmup_scalars(jc, jnp.float32(ni), float(nw), jnp.float32(e), jlf)
        np.testing.assert_allclose(got, [float(w) for w in want], rtol=1e-6)
        for nbs_over_batch in (1.0, 4.0, 2.5, 64 / 3):
            assert P.warmup_accumulate(ni, nw, nbs_over_batch) == int(
                J.warmup_accumulate(jnp.float32(ni), float(nw), nbs_over_batch))
    assert P.scaled_weight_decay(pc, 16, 4) == J.scaled_weight_decay(jc, 16, 4)
    for epochs, nb in ((10, 5), (300, 100)):
        jr = J.resolve_auto(jc._replace(name="auto", epochs=epochs), 12, 16, nb)
        assert tuple(P.resolve_auto(pc._replace(name="auto", epochs=epochs), 12, 16, nb)) == tuple(jr)


def test_updates_match_jax():
    """sgd_update, adamw_update, clip_by_global_norm and ema_update on seeded tensors,
    one of each group."""
    from bsyolo_tpu.engine import optim as J
    from bsyolo_tpu_torch.engine import optim as P

    rng = np.random.default_rng(12)
    shapes = {"w": (4, 3, 3, 3), "n": (4,), "b": (4,)}
    groups = {"w": 0, "n": 1, "b": 2}
    draw = lambda s=1.0: {k: (rng.normal(0, s, v)).astype(np.float32) for k, v in shapes.items()}
    p, g, buf, v = draw(), draw(30.0), draw(0.1), {k: np.abs(x) for k, x in draw(0.01).items()}
    T = lambda d: {k: torch.from_numpy(x.copy()) for k, x in d.items()}
    Jt = lambda d: {k: jnp.asarray(x) for k, x in d.items()}

    jg, jn = J.clip_by_global_norm(Jt(g), 10.0)
    pg, pn = P.clip_by_global_norm(T(g), 10.0)
    np.testing.assert_allclose(float(pn), float(jn), rtol=1e-6)
    _assert_tree_close({k: t.numpy() for k, t in pg.items()}, jg, "clip", rtol=1e-6, atol=0)

    jp, jb = J.sgd_update(Jt(p), jg, Jt(buf), groups, 0.01, 0.05, 0.9, 5e-4)
    pp, pb = P.sgd_update(T(p), pg, T(buf), groups, 0.01, 0.05, 0.9, 5e-4)
    _assert_tree_close({k: t.numpy() for k, t in pp.items()}, jp, "sgd p", rtol=1e-6, atol=1e-7)
    _assert_tree_close({k: t.numpy() for k, t in pb.items()}, jb, "sgd buf", rtol=1e-6, atol=1e-7)

    jp, jm, jv = J.adamw_update(Jt(p), jg, Jt(buf), Jt(v), jnp.float32(3), groups, 0.01, 0.05, 0.937, 5e-4)
    pp, pm, pv = P.adamw_update(T(p), pg, T(buf), T(v), 3, groups, 0.01, 0.05, 0.937, 5e-4)
    for got, want, what in ((pp, jp, "p"), (pm, jm, "m"), (pv, jv, "v")):
        _assert_tree_close({k: t.numpy() for k, t in got.items()}, want, f"adamw {what}", rtol=1e-6, atol=1e-7)

    je = J.ema_update(Jt(buf), Jt(p), jnp.int32(7))
    pe = P.ema_update(T(buf), T(p), 7)
    _assert_tree_close({k: t.numpy() for k, t in pe.items()}, je, "ema", rtol=1e-6, atol=1e-7)


# --- the train step ----------------------------------------------------------

CASES = {
    # SGD, nbs 4 at batch 2 with 2 warmup iterations: accumulate goes 1, 2, 2, so
    # steps 0, 1, 2 update 1, 0, 1; layer 0 frozen. The three steps run free.
    "sgd-accumulate-frozen": dict(name="SGD", nbs=4, use_adamw=False, frozen=("m0",), updated=[1, 0, 1]),
    # AdamW: each port step starts from the JAX state before it (train_state_from_jax), see ADAM_NOISE
    "adamw": dict(name="AdamW", nbs=2, use_adamw=True, frozen=(), updated=[1, 1, 1]),
}
# Adam moves a parameter by about lr * g / (|g| + eps): where a gradient is at float32 rounding
# noise, the move is +-lr whatever the noise. The BatchNorm bias before SPPF's BatchNorm has an
# analytic gradient of 0 (about 1e-11 on either side, with either sign), and a few other elements
# have gradients whose float32 sums cancel and round differently in XLA and PyTorch. Two correct
# implementations differ there by up to 2 lr. So under AdamW at most ADAM_NOISY of the parameter
# and EMA elements may miss the gate, each within 2 lr, and the count is printed; each AdamW step
# starts from the JAX state before it, so such differences do not travel into the next forward.
ADAM_NOISY = 1e-3


@pytest.fixture(scope="module", params=list(CASES))
def runs(request, tiny):
    """Three steps of each package from the same weights and batches; the states (as
    numpy, JAX layout), metrics and learning rates after each step."""
    from bsyolo_tpu.engine.optim import OptimConfig as JOpt
    from bsyolo_tpu.engine.train_step import StepConfig as JStep, init_train_state as jinit, make_train_step as jmake
    from bsyolo_tpu.losses import DetectionLossConfig as JLoss
    from bsyolo_tpu_torch.engine.optim import OptimConfig
    from bsyolo_tpu_torch.engine.train_step import StepConfig, init_train_state, make_train_step
    from bsyolo_tpu_torch.losses import DetectionLossConfig
    from bsyolo_tpu_torch.utils.weights import train_state_from_jax, train_state_to_jax

    case = CASES[request.param]
    model, spec, variables = tiny
    common = dict(batch_size=B, nb=5, nw=2, use_adamw=case["use_adamw"], weight_decay=0.0005, frozen=case["frozen"])
    okw = dict(name=case["name"], lr0=0.01, epochs=4, nbs=case["nbs"], warmup_bias_lr=0.1)
    jcfg = JStep(loss=JLoss(nc=spec.nc, strides=spec.head_strides), optim=JOpt(**okw), **common)
    jstep = jmake(model, jcfg)
    jstate = jinit({k: jax.tree_util.tree_map(jnp.asarray, v) for k, v in variables.items()}, jcfg)
    port = _port_model(variables)
    pcfg = StepConfig(loss=DetectionLossConfig(nc=spec.nc, strides=spec.head_strides), optim=OptimConfig(**okw),
                      **common)
    pstate = init_train_state(port, pcfg)
    pstep = make_train_step(port, pcfg)
    out = []
    for i in range(3):
        batch = _batch(20 + i)
        if case["use_adamw"] and i:
            pstate = train_state_from_jax(out[-1][1], port)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        want = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), jstate)  # the next step donates jstate
        pstate, pm = pstep(pstate, _port_batch(batch))
        out.append((train_state_to_jax(pstate, want), want, pm, {k: np.asarray(v) for k, v in jm.items()}))
    return case, out


def _compare_states(got, want, adam_lr=None):
    """The gate: params, EMA and BN statistics within rtol 1e-4 / atol 1e-6; the optimizer
    slots and the accumulator (gradient sums, whose small elements cancel, and Adam's
    second moment) within rtol 1e-4 / atol 1e-4 of the largest magnitude in the slot.
    With ``adam_lr``, the params and EMA elements that miss the gate are counted and
    held within 2 * adam_lr; returns (count, number of elements)."""
    missed = total = 0
    for field in ("params", "ema_params", "batch_stats", "slot0", "slot1", "acc_grads"):
        w = getattr(want, field)
        if w is None:
            assert got[field] is None, field
            continue
        flat_w = dict(jax.tree_util.tree_flatten_with_path(to_plain_dict(w))[0])
        scale = max(float(np.abs(x).max()) for x in flat_w.values())
        for path, g in jax.tree_util.tree_flatten_with_path(got[field])[0]:
            x = np.asarray(flat_w[path])
            what = f"{field}{jax.tree_util.keystr(path)}"
            atol = 1e-6 if field in ("params", "ema_params", "batch_stats") else 1e-4 * scale
            if adam_lr is not None and field in ("params", "ema_params"):
                miss = ~np.isclose(g, x, rtol=1e-4, atol=atol)
                assert (np.abs(g - x)[miss] <= 2 * adam_lr).all(), what
                missed, total = missed + int(miss.sum()), total + x.size
            else:
                np.testing.assert_allclose(g, x, rtol=1e-4, atol=atol, err_msg=what)
    for field in ("step", "ema_updates", "last_opt_step"):
        assert got[field] == int(getattr(want, field)), field
    assert got["loss_state"]["updates"] == int(want.loss_state.updates)
    np.testing.assert_allclose(got["loss_state"]["iou_mean"], float(want.loss_state.iou_mean), rtol=1e-6)
    return missed, total


@pytest.mark.parametrize("after", [1, 3])
def test_train_step_matches_jax(runs, after):
    case, out = runs
    got, want, pm, jm = out[after - 1]
    missed, total = _compare_states(got, want, max(pm["lr"], 0.1) if case["use_adamw"] else None)
    fields = [f for f in ("params", "ema_params", "batch_stats", "slot0", "slot1", "acc_grads") if got[f] is not None]
    worst = {f: _max_rel(got[f], to_plain_dict(getattr(want, f))) for f in fields}
    print(f"{case['name']} after {after} step(s): max |port - jax| / (1e-6 + |jax|) {worst}; "
          f"{missed} of {total} parameter and EMA elements outside the gate")
    assert missed <= ADAM_NOISY * total
    for k in ("loss", "box_loss", "cls_loss", "dfl_loss", "lr", "grad_norm"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    assert [o[2]["updated"] for o in out] == [int(o[3]["updated"]) for o in out] == case["updated"]


def test_slot_elision_and_frozen_layer(runs, tiny):
    case, out = runs
    got = out[-1][0]
    assert (got["slot1"] is None) == (not case["use_adamw"])
    assert (got["acc_grads"] is None) == (case["nbs"] <= B)
    if case["frozen"]:
        for a, b in zip(jax.tree_util.tree_leaves(got["params"]["m0"]), jax.tree_util.tree_leaves(tiny[2]["params"]["m0"])):
            np.testing.assert_array_equal(a, b)  # frozen values never move
        # ...while the decayed group's momentum buffer takes the coupled weight decay, as in the JAX package
        slot = got["slot0"]["m0"]
        assert np.abs(slot["conv"]["kernel"]).min() > 0 and not np.abs(slot["bn"]["scale"]).any()


def test_train_state_round_trips_through_the_port(runs, tiny):
    """train_state_from_jax then train_state_to_jax gives the JAX state back, exactly."""
    from bsyolo_tpu_torch.utils.weights import train_state_from_jax, train_state_to_jax

    want = runs[1][1][1]
    got = train_state_to_jax(train_state_from_jax(want, _port_model(tiny[2])), want)
    for field in ("params", "ema_params", "batch_stats", "slot0", "slot1", "acc_grads"):
        w = getattr(want, field)
        if w is None:
            assert got[field] is None
        else:
            jax.tree_util.tree_map(np.testing.assert_array_equal, got[field], to_plain_dict(w))
    assert (got["step"], got["ema_updates"], got["last_opt_step"]) == (2, int(want.ema_updates), int(want.last_opt_step))


def test_options_of_other_families_raise(tiny):
    from bsyolo_tpu_torch.engine.optim import OptimConfig
    from bsyolo_tpu_torch.engine.train_step import StepConfig, make_train_step
    from bsyolo_tpu_torch.losses import DetectionLossConfig

    cfg = StepConfig(loss=DetectionLossConfig(nc=2, strides=(8, 16)), optim=OptimConfig(), batch_size=2, nb=1, nw=1,
                     use_adamw=False, weight_decay=0.0)
    port = _port_model(tiny[2])
    with pytest.raises(ValueError, match="remat='bogus'"):  # remat is ported: only an unknown mode raises
        make_train_step(port, cfg._replace(remat="bogus"))
    make_train_step(port, cfg._replace(remat=True))
    make_train_step(port, cfg._replace(needs_dropout_rng=True))  # dropout is ported: the step owns a generator
    make_train_step(port, cfg._replace(pass_targets=True))  # RT-DETR's targets are ported: so is their generator
