"""Chunked train steps (engine/train_step.py ``make_chunked_train_step``, engine/trainer.py ``stack_batches``) and
the trainer's ``chunk_steps`` in the PyTorch port, against sequential steps and the JAX package.

tests/fixtures/tiny.yaml. Gates: K = 3 chunked steps equal 3 sequential port steps exactly (the same
float ops in the same order); against the JAX package's ``make_chunked_train_step`` from the same
weights and batches, the (K,) loss items within rtol 2e-3 and parameters, EMA and BatchNorm statistics
within rtol 1e-4 / atol 1e-6 (the step gate of tests/test_torch_train_step.py), the weights' atol widened
by 2e-3 of the largest move the JAX steps made in each tensor (``MOVE_SHARE``). The trainer with
``chunk_steps=4`` on 40 frames at batch 8 (one chunk and a tail of one step per epoch) gives the
per-epoch losses of the trainer without chunks exactly, and the JAX trainer's with ``chunk_steps=4``
within rtol 2e-3 (tests/test_torch_trainer.py's short leg).
"""

import csv
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
K = 3
# float32 gradient sums that cancel round differently in XLA and PyTorch; over three steps a weight whose
# gradient is such a sum moves up to this share of its tensor's move apart (the share
# tests/test_torch_nas.py holds the NAS step's moves to)
MOVE_SHARE = 2e-3


def _host_batches(k=K):
    from test_torch_train_step import _batch

    return [_batch(40 + i) for i in range(k)]


@pytest.fixture(scope="module")
def tiny():
    from bsyolo_tpu.nn import load_model_yaml, parse_model_yaml
    from bsyolo_tpu.nn.model import DetectionGraph

    spec = parse_model_yaml(load_model_yaml(TINY))
    model = DetectionGraph(spec)
    return model, spec, to_plain_dict(random_variables(variable_shapes(model, (1, 64, 64, 3)), seed=6))


def _port(variables, spec):
    from bsyolo_tpu_torch.engine.optim import OptimConfig
    from bsyolo_tpu_torch.engine.train_step import StepConfig
    from bsyolo_tpu_torch.losses import DetectionLossConfig
    from test_torch_remat import _port_model

    cfg = StepConfig(loss=DetectionLossConfig(nc=spec.nc, strides=spec.head_strides),
                     optim=OptimConfig(name="SGD", lr0=0.01, epochs=4, nbs=4, warmup_bias_lr=0.1), batch_size=2,
                     nb=5, nw=2, use_adamw=False, weight_decay=0.0005)
    return _port_model(variables), cfg


def _snap(state):
    return {f: {k: v.detach().clone() for k, v in getattr(state, f).items()}
            for f in ("params", "ema_params", "batch_stats", "slot0", "acc_grads")}


@pytest.fixture(scope="module")
def chunked(tiny):
    from bsyolo_tpu_torch.engine.train_step import init_train_state, make_chunked_train_step
    from bsyolo_tpu_torch.engine.trainer import stack_batches

    _, spec, variables = tiny
    model, cfg = _port(variables, spec)
    state = init_train_state(model, cfg)
    batches = stack_batches(_host_batches(), torch.device("cpu"))
    state, metrics = make_chunked_train_step(model, cfg)(state, batches)
    return state, _snap(state), metrics


def test_stack_batches_layout():
    from bsyolo_tpu_torch.engine.trainer import stack_batches

    hosts = _host_batches()
    got = stack_batches(hosts, torch.device("cpu"))
    assert got["img"].shape == (K, 2, 3, 64, 64) and got["img"].dtype == torch.uint8 and got["img"].is_contiguous()
    assert got["cls"].dtype == torch.int64 and got["bboxes"].shape == (K, 2, 4, 4)
    for i, h in enumerate(hosts):
        np.testing.assert_array_equal(got["img"][i].numpy(), nchw(h["img"]))
        np.testing.assert_array_equal(got["mask"][i].numpy(), h["mask"])


def test_chunk_equals_sequential_steps(tiny, chunked):
    """K chunked steps == K calls of the step: the same states (accumulation at nbs 4, batch 2: steps
    0 to 2 update 1, 0, 1 under the warmup) and per-step metrics, as (K,) tensors."""
    from bsyolo_tpu_torch.engine.train_step import init_train_state, make_train_step
    from test_torch_remat import _port_batch

    _, spec, variables = tiny
    model, cfg = _port(variables, spec)
    state, step = init_train_state(model, cfg), make_train_step(model, cfg)
    seq = []
    for b in _host_batches():
        state, m = step(state, _port_batch(b))
        seq.append(m)
    cstate, got, metrics = chunked
    for k in ("loss", "box_loss", "cls_loss", "dfl_loss", "grad_norm", "lr", "updated"):
        assert metrics[k].shape == (K,) and torch.is_tensor(metrics[k]), k
        np.testing.assert_array_equal(metrics[k].numpy(), np.array([float(m[k]) for m in seq], np.float32), k)
    assert metrics["updated"].tolist() == [1.0, 0.0, 1.0]
    want = _snap(state)
    for f, tree in want.items():
        for k, v in tree.items():
            torch.testing.assert_close(got[f][k], v, rtol=0, atol=0, msg=f"{f} {k}")
    assert (cstate.step, cstate.ema_updates, cstate.last_opt_step) == (state.step, state.ema_updates,
                                                                       state.last_opt_step) == (3, 2, 2)


def test_chunk_matches_jax_chunked_step(tiny, chunked):
    from bsyolo_tpu.engine.optim import OptimConfig as JOpt
    from bsyolo_tpu.engine.train_step import StepConfig as JStep, init_train_state as jinit
    from bsyolo_tpu.engine.train_step import make_chunked_train_step as jchunk
    from bsyolo_tpu.losses import DetectionLossConfig as JLoss
    from bsyolo_tpu_torch.utils.weights import train_state_to_jax

    model, spec, variables = tiny
    jcfg = JStep(loss=JLoss(nc=spec.nc, strides=spec.head_strides),
                 optim=JOpt(name="SGD", lr0=0.01, epochs=4, nbs=4, warmup_bias_lr=0.1), batch_size=2, nb=5, nw=2,
                 use_adamw=False, weight_decay=0.0005)
    jstate = jinit({k: jax.tree_util.tree_map(jnp.asarray, v) for k, v in variables.items()}, jcfg)
    hosts = _host_batches()
    stacked = {k: jnp.asarray(np.stack([h[k] for h in hosts])) for k in hosts[0]}
    jstate, jm = jchunk(model, jcfg)(jstate, stacked)
    want = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), jstate)
    cstate, _, metrics = chunked
    got = train_state_to_jax(cstate, want)
    for k in ("loss", "box_loss", "cls_loss", "dfl_loss"):
        np.testing.assert_allclose(metrics[k].numpy(), np.asarray(jm[k]), rtol=2e-3, err_msg=k)
    np.testing.assert_array_equal(metrics["updated"].numpy(), np.asarray(jm["updated"]))
    init = dict(jax.tree_util.tree_flatten_with_path(variables["params"])[0])
    for field in ("params", "ema_params", "batch_stats"):
        flat_w = dict(jax.tree_util.tree_flatten_with_path(to_plain_dict(getattr(want, field)))[0])
        for path, g in jax.tree_util.tree_flatten_with_path(got[field])[0]:
            w = np.asarray(flat_w[path])
            # the step gate, widened for weights by MOVE_SHARE of the largest move JAX's steps made in the tensor
            move = float(np.abs(w - init[path]).max()) if field != "batch_stats" else 0.0
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6 + MOVE_SHARE * move,
                                       err_msg=f"{field}{jax.tree_util.keystr(path)}")
    assert got["step"] == int(want.step) == K


def _csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def trainer_legs(tmp_path_factory):
    """The port's trainer with chunk_steps 4 and 0, and the JAX trainer with chunk_steps 4, from one init.ckpt:
    40 train frames at batch 8, so each epoch is one chunk and a tail of one step."""
    from bsyolo_tpu.engine.trainer import DetectionTrainer as JaxTrainer
    from test_torch_data import write_dataset
    from test_torch_trainer import COMMON, _write_init_ckpt

    from bsyolo_tpu_torch.engine.trainer import DetectionTrainer

    root = tmp_path_factory.mktemp("torch_chunk")
    data = write_dataset(root / "ds", n_train=40)
    _write_init_ckpt(root / "init.ckpt", 3, ("red", "green", "blue"))
    kw = dict(COMMON, data=str(data), pretrained=str(root / "init.ckpt"), project=str(root / "runs"), epochs=1,
              close_mosaic=0, val=False)
    out = {}
    for name, chunk in (("port4", 4), ("port0", 0)):
        out[name] = DetectionTrainer(overrides=dict(kw, name=name, device="cpu", chunk_steps=chunk))
        out[name].train()
    out["jax4"] = JaxTrainer(overrides=dict(kw, name="jax4", chunk_steps=4))
    out["jax4"].train()
    return out


def test_trainer_chunks_with_a_tail(trainer_legs):
    """Every batch trains (one chunk of 4 and a tail of 1), with the losses and weights of the trainer that
    takes one step per batch."""
    c, s = trainer_legs["port4"], trainer_legs["port0"]
    assert c.chunk_step is not None and s.chunk_step is None
    assert c.state.step == s.state.step == 5
    rc, rs = _csv(c.csv_path), _csv(s.csv_path)
    for k in ("box_loss", "cls_loss", "dfl_loss", "loss"):
        assert float(rc[0][k]) == float(rs[0][k]), k
    for k, v in s.state.params.items():
        torch.testing.assert_close(c.state.params[k], v, rtol=0, atol=0, msg=k)


def test_trainer_chunks_match_the_jax_trainer(trainer_legs):
    rp, rj = _csv(trainer_legs["port4"].csv_path), _csv(trainer_legs["jax4"].csv_path)
    assert int(trainer_legs["jax4"].state.step) == trainer_legs["port4"].state.step == 5
    for k in ("box_loss", "cls_loss", "dfl_loss", "loss"):
        np.testing.assert_allclose(float(rp[0][k]), float(rj[0][k]), rtol=2e-3, err_msg=k)


def test_chunks_are_off_under_multi_scale(tmp_path):
    from bsyolo_tpu_torch.engine.trainer import DetectionTrainer
    from test_torch_data import write_dataset
    from test_torch_trainer import COMMON

    data = write_dataset(tmp_path / "ds", n_train=8)
    tr = DetectionTrainer(overrides=dict(COMMON, data=str(data), device="cpu", chunk_steps=4, multi_scale=True,
                                         project=str(tmp_path / "runs")))
    tr.setup()
    assert tr.chunk_step is None
