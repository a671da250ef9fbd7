"""Training YOLO-World in the PyTorch port against bsyolo_tpu.

One SGD step of tests/fixtures/tinyworld.yaml with a bound text (the contrastive logits in the detection loss)
from the same weights and batch: loss items within 2e-3, params, EMA, BatchNorm statistics and momentum at
tests/test_torch_train_step.py's gates. ``YOLOWorld.train`` one epoch in each facade from one checkpoint of
seeded weights: both train against the same text (the hashed n-grams of the data's class names), both write it
into ``best.ckpt`` as ``txt_feats``, and each package's checkpoint, loaded by the other, predicts the rows the
writer's own facade predicts from it.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import jax
import jax.numpy as jnp
import torch

from torch_port import (jax_spec, port_batch, port_module_from_jax, port_spec, random_variables, task_batch,
                        to_plain_dict, variable_shapes)

TINY_WORLD = str(Path(__file__).parent / "fixtures" / "tinyworld.yaml")
IMG = 64


def test_sgd_step_matches_jax():
    from bsyolo_tpu.engine.optim import OptimConfig as JOpt
    from bsyolo_tpu.engine.train_step import StepConfig as JStep, init_train_state as jinit, make_train_step as jmake
    from bsyolo_tpu.losses import DetectionLossConfig as JLoss
    from bsyolo_tpu.nn.model import DetectionGraph, TextConditioned

    from bsyolo_tpu_torch.engine.optim import OptimConfig
    from bsyolo_tpu_torch.engine.train_step import StepConfig, init_train_state, make_train_step, task_criterion
    from bsyolo_tpu_torch.losses import DetectionLossConfig
    from bsyolo_tpu_torch.nn.model import bind_text, build_model
    from bsyolo_tpu_torch.utils.text_embed import hashed_text_embeddings
    from bsyolo_tpu_torch.utils.weights import train_state_to_jax
    from test_torch_train_step import _compare_states

    spec = jax_spec(TINY_WORLD)
    jm = DetectionGraph(spec)
    v = to_plain_dict(random_variables(variable_shapes(jm, (1, IMG, IMG, 3)), seed=6))
    text = hashed_text_embeddings(["square", "circle"])[None]
    common = dict(batch_size=2, nb=5, nw=2, use_adamw=False, weight_decay=0.0005)
    okw = dict(name="SGD", lr0=0.01, epochs=4, nbs=2, warmup_bias_lr=0.1)
    jcfg = JStep(loss=JLoss(nc=spec.nc, strides=spec.head_strides), optim=JOpt(**okw), **common)
    jstep = jmake(TextConditioned(jm, jnp.asarray(text)), jcfg)
    jstate = jinit({k: jax.tree_util.tree_map(jnp.asarray, x) for k, x in v.items()}, jcfg)
    pm = bind_text(port_module_from_jax(build_model(port_spec(TINY_WORLD), "cpu"), v), text)
    pcfg = StepConfig(loss=DetectionLossConfig(nc=spec.nc, strides=spec.head_strides), optim=OptimConfig(**okw),
                      **common)
    pstate = init_train_state(pm, pcfg)
    pstep = make_train_step(pm, pcfg, *task_criterion(pm.spec))
    batch = {k: x for k, x in task_batch(7, 2, IMG, 6, spec.nc, "detect").items() if k != "keypoints"}
    jstate, jmet = jstep(jstate, {k: jnp.asarray(x) for k, x in batch.items()})
    want = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), jstate)
    pstate, pmet = pstep(pstate, {k: torch.as_tensor(x).long() if k == "cls" else torch.as_tensor(x)
                                  for k, x in port_batch(batch).items()})
    for k in ("loss", "box_loss", "cls_loss", "dfl_loss"):
        np.testing.assert_allclose(float(pmet[k]), float(jmet[k]), rtol=2e-3, err_msg=k)
    _compare_states(train_state_to_jax(pstate, want), want)
    grads = [k for k in pstate.params if k.endswith("logit_scale")]  # the contrastive heads' scale moved
    assert grads and all(float(pstate.slot0[k].abs()) > 0 for k in grads)


def test_world_text_resolves_tables_as_jax(tmp_path):
    """The trainer's text from a {name: vector} table or an .npz: JAX's resolved rows, L2-normalized; a wrong
    row count raises."""
    from bsyolo_tpu.utils.text_embed import resolve_text_embeddings

    from bsyolo_tpu_torch.utils.text_embed import world_text

    rng = np.random.default_rng(3)
    table = {n: rng.normal(size=512).astype(np.float32) for n in ("red", "green", "blue", "azure")}
    np.savez(tmp_path / "t.npz", **table)
    names = ["red", "green", "blue/azure"]
    want = resolve_text_embeddings(names, table)
    want = want / (np.linalg.norm(want, axis=-1, keepdims=True) + 1e-12)
    for src in (table, str(tmp_path / "t.npz"), want * 3.0, (want * 3.0).tolist()):
        got = world_text(names, src)
        assert got.shape == (1, 3, 512) and got.dtype == np.float32
        np.testing.assert_allclose(got[0], want, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match=r"must be \(3, embed\); got \(2, 512\)"):
        world_text(names, want[:2])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One epoch of ``YOLOWorld.train`` in each facade from one checkpoint of seeded weights (SGD, amp off, no
    augmentation that moves pixels): {"data", "jax", "port"} with each facade after its training."""
    from bsyolo_tpu import YOLOWorld as JaxWorld
    from bsyolo_tpu.nn.model import DetectionGraph

    from bsyolo_tpu_torch import YOLOWorld
    from test_torch_data import write_dataset
    from zoo_port import EXACT_PIXELS

    root = tmp_path_factory.mktemp("world_train")
    data = write_dataset(root / "ds", n_train=8, n_val=4)
    seeded = YOLOWorld(TINY_WORLD, device="cpu")
    v = to_plain_dict(random_variables(variable_shapes(DetectionGraph(jax_spec(TINY_WORLD)), (1, IMG, IMG, 3)), 8))
    port_module_from_jax(seeded.model, v)
    seeded.save(root / "seeded.ckpt")
    kw = dict(data=str(data), epochs=1, imgsz=IMG, batch=8, nbs=8, optimizer="SGD", lr0=0.002, warmup_epochs=0.0,
              workers=0, amp=False, plots=False, close_mosaic=0, seed=3, max_gt=16, pretrained=str(root / "seeded.ckpt"),
              project=str(root / "runs"), **EXACT_PIXELS)
    jy, port = JaxWorld(TINY_WORLD), YOLOWorld(TINY_WORLD, device="cpu")
    jy.train(**kw, name="jax")
    port.train(**kw, name="port")
    return {"data": data, "jax": jy, "port": port, "runs": root / "runs"}


FRAMES = [np.random.default_rng(30 + i).integers(0, 256, (64, 80, 3), dtype=np.uint8) for i in range(2)]


def test_both_facades_train_against_the_same_text(trained):
    from bsyolo_tpu_torch.utils.ckpt import load_checkpoint

    jy, port = trained["jax"], trained["port"]
    assert port.txt_feats.shape == (1, 3, 512) and port.names == {0: "red", 1: "green", 2: "blue"}
    np.testing.assert_allclose(port.txt_feats, np.asarray(jy.txt_feats), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(port.model.txt_feats.numpy(), port.txt_feats)
    for who in ("jax", "port"):
        payload, meta = load_checkpoint(trained["runs"] / who / "weights" / "best.ckpt")
        np.testing.assert_array_equal(np.asarray(payload["txt_feats"]), port.txt_feats)
        assert meta["names"] == ["red", "green", "blue"]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_packages_checkpoint_predicts_as_its_writer(writer, trained):
    """``best.ckpt`` of one package loaded by both: the other's rows pair one to one with the writer's."""
    from bsyolo_tpu import YOLO as JaxYOLO

    from bsyolo_tpu_torch import YOLO
    from zoo_port import paired_rows

    best = trained["runs"] / writer / "weights" / "best.ckpt"
    jy, port = JaxYOLO(str(best)), YOLO(best, device="cpu")
    assert port.txt_feats.shape == (1, 3, 512) and port.spec.nc == 3 and port.names == jy.names
    np.testing.assert_array_equal(port.model.txt_feats.numpy(), np.asarray(jy.txt_feats))
    kw = dict(imgsz=IMG, conf=0.25, batch=2)
    want = [np.asarray(r.boxes.data) for r in jy.predict(FRAMES, **kw)]
    got = [r.boxes.data for r in port.predict(FRAMES, **kw)]
    for g, w in zip(got, want):
        assert len(g) == len(w) >= 5 and len(paired_rows(g, w)) == len(w)
