"""The train step's remat (nn/model.py ``remat_mode``, ``DetectionGraph.forward(remat=)``) in the PyTorch
port: a schedule change only.

tests/fixtures/tiny.yaml at imgsz 64, batch 2. Gates: each mode's steps give the plain port step's
loss items, parameters, EMA and BatchNorm statistics (they agree bit for bit here: the recomputation
runs the same float ops); against the JAX step with the same remat mode (``bsyolo_tpu/engine/
train_step.py remat_policy``), loss items within rtol 2e-3 and parameters, EMA and BatchNorm statistics
at the step gate of tests/test_torch_train_step.py (rtol 1e-4 / atol 1e-6). A Classify graph with
dropout and a tiny RT-DETR graph with denoising queries show that the recomputation draws what the
first forward drew from the step's explicit generators.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import jax
import jax.numpy as jnp
import torch

from torch_port import nchw, random_variables, share_cores, to_plain_dict, variable_shapes

share_cores()

TINY = str(Path(__file__).parent / "fixtures" / "tiny.yaml")
TINYCLS = str(Path(__file__).parent / "fixtures" / "tinycls.yaml")
MODES = ("full", "seg", "light")
CALLS = {"full": 2, "seg": 2, "light": 1}  # calls of a layer per step (its forward and recomputation; light remakes
# only the boundary outputs' activations)


def _batch(seed, b=2, size=64, m=4, nc=2):
    from test_torch_train_step import _batch as draw

    return draw(seed, b, size, nc)


def _port_batch(batch):
    return {k: torch.from_numpy(nchw(v) if k == "img" else v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def tiny():
    from bsyolo_tpu.nn import load_model_yaml, parse_model_yaml
    from bsyolo_tpu.nn.model import DetectionGraph

    spec = parse_model_yaml(load_model_yaml(TINY))
    model = DetectionGraph(spec)
    return model, spec, to_plain_dict(random_variables(variable_shapes(model, (1, 64, 64, 3)), seed=5))


def _port_model(variables, yaml=TINY, **spec_kw):
    import dataclasses

    from bsyolo_tpu_torch.nn.model import DetectionGraph
    from bsyolo_tpu_torch.nn.parser import load_model_yaml, parse_model_yaml
    from bsyolo_tpu_torch.utils.weights import state_dict_from_jax

    model = DetectionGraph(dataclasses.replace(parse_model_yaml(load_model_yaml(yaml)), **spec_kw))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def _step_cfg(spec, **kw):
    from bsyolo_tpu_torch.engine.optim import OptimConfig
    from bsyolo_tpu_torch.engine.train_step import StepConfig
    from bsyolo_tpu_torch.losses import DetectionLossConfig

    return StepConfig(loss=DetectionLossConfig(nc=spec.nc, strides=spec.head_strides),
                      optim=OptimConfig(name="SGD", lr0=0.01, epochs=4, nbs=2, warmup_bias_lr=0.1),
                      batch_size=2, nb=5, nw=2, use_adamw=False, weight_decay=0.0005, **kw)


def _run(model, cfg, batches, criterion=None, items=None):
    """The port's steps over ``batches``; (metrics per step, params, EMA, BatchNorm statistics as numpy,
    forward calls of the first layer)."""
    from bsyolo_tpu_torch.engine.train_step import DETECT_ITEMS, init_train_state, make_train_step

    calls = []
    model.model[0].register_forward_pre_hook(lambda *a: calls.append(1))  # a recomputation may stop inside a layer
    state = init_train_state(model, cfg)
    step = make_train_step(model, cfg, criterion, items or DETECT_ITEMS)
    metrics = []
    for b in batches:
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    snap = lambda d: {k: v.detach().numpy().copy() for k, v in d.items()}
    return metrics, snap(state.params), snap(state.ema_params), snap(state.batch_stats), len(calls)


@pytest.mark.parametrize("value,want", [(False, None), ("", None), ("0", None), ("off", None), ("none", None),
                                        (True, "full"), ("full", "full"), ("1", "full"), ("seg", "seg"),
                                        ("SEG", "seg"), ("light", "light")])
def test_remat_mode_matches_jax_policy(value, want):
    from bsyolo_tpu.engine.train_step import remat_policy
    from bsyolo_tpu_torch.nn.model import remat_mode

    assert remat_mode(value) == want
    assert (remat_policy(value) is None) == (want is None)


def test_remat_mode_validation():
    from bsyolo_tpu.engine.train_step import remat_policy
    from bsyolo_tpu_torch.engine.train_step import make_train_step
    from bsyolo_tpu_torch.nn.model import remat_mode

    with pytest.raises(ValueError) as jerr:
        remat_policy("bogus")
    with pytest.raises(ValueError) as perr:
        remat_mode("bogus")
    assert str(perr.value) == str(jerr.value)
    from bsyolo_tpu_torch.nn.model import build_model
    from bsyolo_tpu_torch.nn.parser import load_model_yaml, parse_model_yaml

    spec = parse_model_yaml(load_model_yaml(TINY))
    with pytest.raises(ValueError, match="remat='bogus'"):
        make_train_step(build_model(spec, "cpu"), _step_cfg(spec, remat="bogus"))


@pytest.fixture(scope="module")
def plain_run(tiny):
    _, spec, variables = tiny
    return _run(_port_model(variables), _step_cfg(spec), [_port_batch(_batch(20 + i)) for i in range(2)])


@pytest.mark.parametrize("mode", MODES)
def test_remat_step_equals_plain_step(tiny, plain_run, mode):
    """Two steps under each mode give the plain step's loss items, parameters, EMA and BatchNorm statistics
    (updated once per step: the recomputed forward leaves them alone), and the backward ran the layers again."""
    _, spec, variables = tiny
    got = _run(_port_model(variables), _step_cfg(spec, remat=mode), [_port_batch(_batch(20 + i)) for i in range(2)])
    for g, w in zip(got[0], plain_run[0]):
        for k in ("loss", "box_loss", "cls_loss", "dfl_loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=2e-3, err_msg=k)
    for i, what in ((1, "params"), (2, "ema"), (3, "batch_stats")):
        for k, w in plain_run[i].items():
            np.testing.assert_allclose(got[i][k], w, rtol=1e-4, atol=1e-6, err_msg=f"{what} {k}")
    # the first layer runs once more per step in full and seg (light remakes activations, not layers)
    assert plain_run[4] == 2 and got[4] == 2 * CALLS[mode], (plain_run[4], got[4])


def test_light_frees_the_boundary_outputs(tiny):
    """After a train-mode forward under remat light no boundary layer's output that ends in its activation
    is held (the ops that read it keep the activation's input, the backward makes it again); without
    remat the convolutions that read such outputs hold them. The backward then gives the same gradients."""
    import gc
    import weakref

    from bsyolo_tpu_torch.nn.model import is_boundary

    _, spec, variables = tiny
    x = torch.from_numpy(nchw(_batch(20)["img"])).float() / 255
    held, grads = {}, {}
    for remat in (None, "light"):
        model = _port_model(variables).train()
        outs = []

        def keep(mod, inp, out, layer):
            if is_boundary(layer, out) and type(out.grad_fn).__name__ == "SiluBackward0":
                outs.append(weakref.ref(out))

        for layer, m in zip(model.spec.layers, model.model):
            m.register_forward_hook(lambda mod, inp, out, layer=layer: keep(mod, inp, out, layer))
        maps = model(x, remat=remat)
        gc.collect()
        held[remat] = [r() is not None for r in outs]
        sum(t.square().mean() for t in maps).backward()
        grads[remat] = [p.grad for p in model.parameters()]
    assert len(held["light"]) == len(held[None]) > 0
    assert not any(held["light"]) and any(held[None]), held
    for a, b in zip(grads["light"], grads[None]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("mode", MODES)
def test_remat_step_matches_jax_step(tiny, mode):
    """One SGD step of each package with the same remat mode from the same weights and batch."""
    from bsyolo_tpu.engine.optim import OptimConfig as JOpt
    from bsyolo_tpu.engine.train_step import StepConfig as JStep, init_train_state as jinit, make_train_step as jmake
    from bsyolo_tpu.losses import DetectionLossConfig as JLoss
    from bsyolo_tpu_torch.utils.weights import state_dict_from_jax

    model, spec, variables = tiny
    jcfg = JStep(loss=JLoss(nc=spec.nc, strides=spec.head_strides),
                 optim=JOpt(name="SGD", lr0=0.01, epochs=4, nbs=2, warmup_bias_lr=0.1), batch_size=2, nb=5, nw=2,
                 use_adamw=False, weight_decay=0.0005, remat=True if mode == "full" else mode)
    jstate = jinit({k: jax.tree_util.tree_map(jnp.asarray, v) for k, v in variables.items()}, jcfg)
    batch = _batch(30)
    jstate, jm = jmake(model, jcfg)(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    got = _run(_port_model(variables), _step_cfg(spec, remat=mode), [_port_batch(batch)])
    for k in ("loss", "box_loss", "cls_loss", "dfl_loss"):
        np.testing.assert_allclose(got[0][0][k], float(jm[k]), rtol=2e-3, err_msg=k)
    want_p = state_dict_from_jax({"params": to_plain_dict(jax.tree_util.tree_map(np.asarray, jstate.params))})
    want_e = state_dict_from_jax({"params": to_plain_dict(jax.tree_util.tree_map(np.asarray, jstate.ema_params))})
    want_b = state_dict_from_jax({"batch_stats": to_plain_dict(jax.tree_util.tree_map(np.asarray,
                                                                                      jstate.batch_stats))})
    for i, want in ((1, want_p), (2, want_e), (3, want_b)):
        for k, w in want.items():
            np.testing.assert_allclose(got[i][k], w.numpy(), rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("mode", MODES)
def test_remat_replays_classify_dropout(mode):
    """A Classify graph with dropout 0.5: each mode's step equals the plain step, so the recomputed
    forward drew the same mask from the step's dropout generator."""
    from bsyolo_tpu.nn import load_model_yaml, parse_model_yaml
    from bsyolo_tpu.nn.model import DetectionGraph
    from bsyolo_tpu_torch.engine.train_step import task_criterion

    jm = DetectionGraph(parse_model_yaml(load_model_yaml(TINYCLS)))
    variables = to_plain_dict(random_variables(variable_shapes(jm, (1, 32, 32, 3)), seed=2))
    rng = np.random.default_rng(3)
    batches = [{"img": torch.from_numpy(rng.integers(0, 256, (4, 3, 32, 32), dtype=np.uint8)),
                "cls": torch.from_numpy(rng.integers(0, 2, (4,)))} for _ in range(2)]
    runs = []
    for remat in (False, mode):
        model = _port_model(variables, TINYCLS, dropout=0.5)
        cfg = _step_cfg(model.spec, remat=remat, needs_dropout_rng=True)
        runs.append(_run(model, cfg, batches, *task_criterion(model.spec)))
    (pm, pp, _, pb, _), (gm, gp, _, gb, calls) = runs
    assert [m["loss"] for m in gm] == [m["loss"] for m in pm]
    for k in pp:
        np.testing.assert_array_equal(gp[k], pp[k], err_msg=k)
    for k in pb:
        np.testing.assert_array_equal(gb[k], pb[k], err_msg=k)
    assert calls == 2 * CALLS[mode]


def test_remat_replays_rtdetr_denoising():
    """A tiny RT-DETR graph (denoising queries drawn from the step's generator): the full remat step
    equals the plain one."""
    from rtdetr_port import label_batch, tiny_specs

    from bsyolo_tpu_torch.engine.train_step import task_criterion
    from bsyolo_tpu_torch.nn.model import build_model

    _, spec = tiny_specs(nc=4)
    cls, bboxes, mask = label_batch(4, 2, 6, 4)
    img = np.random.default_rng(5).integers(0, 256, (2, 3, 64, 64), dtype=np.uint8)
    batch = {"img": torch.from_numpy(img), "cls": torch.from_numpy(cls.astype(np.int64)),
             "bboxes": torch.from_numpy(bboxes), "mask": torch.from_numpy(mask)}
    runs = []
    for remat in (False, "full"):
        cfg = _step_cfg(spec, remat=remat, pass_targets=True)._replace(use_adamw=True)
        runs.append(_run(build_model(spec, "cpu", seed=1), cfg, [batch], *task_criterion(spec)))
    (pm, pp, _, pb, _), (gm, gp, _, gb, calls) = runs
    assert [m["loss"] for m in gm] == [m["loss"] for m in pm]  # the same denoising queries
    for k in pp:  # the embedding's gradient sums in another order in the remat backward (7e-9 seen)
        np.testing.assert_allclose(gp[k], pp[k], rtol=1e-4, atol=1e-6, err_msg=k)
    for k in pb:
        np.testing.assert_allclose(gb[k], pb[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert calls == CALLS["full"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("yaml", ["tinyworld.yaml", "tinyseg.yaml", "tiny_nas.yaml", "tinypose.yaml"])
def test_remat_on_other_graph_families_equals_plain(yaml, mode):
    """A train-mode forward and backward of the World (text state across layers), Segment (a dict head), NAS
    (multi-input merges) and Pose graphs under each mode: the same loss, gradients and BatchNorm statistics."""
    import copy

    from bsyolo_tpu_torch.nn.model import build_model
    from bsyolo_tpu_torch.nn.parser import load_model_yaml, parse_model_yaml

    d = load_model_yaml(str(Path(__file__).parent / "fixtures" / yaml))
    model = build_model(parse_model_yaml(d, scale=d.get("scale", "")), "cpu", seed=4).train()
    x = torch.from_numpy(np.random.default_rng(6).uniform(0, 1, (2, 3, 64, 64)).astype(np.float32))
    runs = []
    for remat in (None, mode):
        g = copy.deepcopy(model)
        out = g(x, remat=remat)
        maps = list(out["feats"]) + [out["proto"]] if isinstance(out, dict) else list(out)
        loss = sum(t.float().square().mean() for t in maps)
        loss.backward()
        runs.append((loss.item(), [p.grad for p in g.parameters()],
                     [b for n, b in g.named_buffers() if n.endswith(("running_mean", "running_var"))]))
    (lp, gp, bp), (lr, gr, br) = runs
    assert lr == lp
    for a, b in zip(gr + br, gp + bp):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
