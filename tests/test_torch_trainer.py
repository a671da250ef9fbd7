"""The port's trainer, checkpoints, facade and CLI against the JAX package, on the CPU.

The short leg: tests/fixtures/tiny.yaml on a 3-class PNG dataset written here
(24 train, 6 val frames), imgsz 64, batch 8 (the JAX tests' 8-device mesh), nbs 8, SGD, amp=False,
workers=0, mosaic in epoch 0 and closed in epoch 1, flips on, warps and HSV
off (``EXACT_PIXELS``: the batches are then byte-identical, so the leg holds
the trainer and not the data ops' residue). Both trainers start from
one ``init.ckpt`` written by the JAX package (``pretrained=``) and run once
per module. Tolerances: per-epoch loss items within 2e-3 relative (the
ROADMAP loss gate), final params and EMA within 1e-3 norm-relative per
tensor (norms floored at 1e-5), validation metrics within 1e-6; ``results.csv`` columns equal;
checkpoints read across packages exactly (max abs 0).
"""

import csv
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

from test_torch_data import write_dataset  # noqa: E402

TINY = str(Path(__file__).parent / "fixtures" / "tiny.yaml")
# augmentation whose pixels the port reproduces byte for byte (mosaic, flips, whole-pixel shifts): the
# trainer legs then hold the trainer on identical batches; the residue of the warps and HSV, and
# where it moves training, is tests/test_torch_data.py's subject
EXACT_PIXELS = dict(translate=0.0, scale=0.0, hsv_h=0.0, hsv_s=0.0, hsv_v=0.0)
COMMON = dict(model=TINY, epochs=2, imgsz=64, batch=8, nbs=8, optimizer="SGD", lr0=0.01, workers=0, amp=False,
              plots=False, close_mosaic=1, seed=3, max_gt=16, **EXACT_PIXELS)
LOSSES = ("box_loss", "cls_loss", "dfl_loss", "loss")


def _csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _write_init_ckpt(path, data_nc, names):
    """The JAX package's seeded init of tiny.yaml at the data's class count, saved by the JAX package."""
    from bsyolo_tpu.engine.train_step import init_train_state
    from bsyolo_tpu.engine.trainer import save_checkpoint
    from bsyolo_tpu.nn import build_model, load_model_yaml, parse_model_yaml

    d = load_model_yaml(TINY)
    d["nc"] = data_nc
    _, variables = build_model(parse_model_yaml(d), img_size=64, seed=7)
    save_checkpoint(Path(path), init_train_state(variables), {"args": {"model": TINY}, "epoch": -1,
                                                              "names": list(names)})


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    """One JAX and one port run of the short leg from one init.ckpt."""
    from bsyolo_tpu.engine.trainer import DetectionTrainer as JaxTrainer

    from bsyolo_tpu_torch.engine.trainer import DetectionTrainer

    root = tmp_path_factory.mktemp("torch_trainer")
    data = write_dataset(root / "ds", n_train=24)
    _write_init_ckpt(root / "init.ckpt", 3, ("red", "green", "blue"))
    kw = dict(COMMON, data=str(data), pretrained=str(root / "init.ckpt"), project=str(root / "runs"))
    jax_tr = JaxTrainer(overrides=dict(kw, name="jax"))
    jax_tr.train()
    port_tr = DetectionTrainer(overrides=dict(kw, name="port", device="cpu"))
    port_tr.train()
    return {"root": root, "data": data, "jax": jax_tr, "port": port_tr}


def test_short_leg_losses_and_csv_columns_match(legs):
    j, p = _csv(legs["jax"].csv_path), _csv(legs["port"].csv_path)
    assert list(j[0].keys()) == list(p[0].keys())
    assert [r["epoch"] for r in j] == [r["epoch"] for r in p] == ["0", "1"]
    for rj, rp in zip(j, p):
        for k in LOSSES:
            np.testing.assert_allclose(float(rp[k]), float(rj[k]), rtol=2e-3, err_msg=k)


def _rel_norm(a, b):
    """||a - b|| / ||b||, the norm floored at 1e-5: a few tensors (a BatchNorm bias no gradient
    reaches) are float rounding around zero, of norm 1e-9, and have no relative scale."""
    return float(np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64))
                 / max(np.linalg.norm(np.asarray(b, np.float64)), 1e-5))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_short_leg_params_ema_and_metrics_match(legs):
    from bsyolo_tpu_torch.utils.weights import train_state_to_jax

    js = legs["jax"].state
    ps = train_state_to_jax(legs["port"].state, js)
    for field in ("params", "ema_params", "batch_stats"):
        want = dict(_leaves(getattr(js, field)))
        got = dict(_leaves(ps[field]))
        assert got.keys() == want.keys()
        worst = max(_rel_norm(got[k], want[k]) for k in want)
        assert worst <= 1e-3, (field, worst)
    assert ps["step"] == int(js.step) == 6 and ps["ema_updates"] == int(js.ema_updates)
    jm, pm = legs["jax"].metrics.results_dict, legs["port"].metrics.results_dict
    assert jm.keys() == pm.keys()
    np.testing.assert_allclose([float(pm[k]) for k in jm], [float(jm[k]) for k in jm], atol=1e-6)


def test_checkpoints_read_across_packages_exactly(legs):
    from bsyolo_tpu.engine.trainer import load_checkpoint as jax_load

    from bsyolo_tpu_torch.utils.ckpt import load_checkpoint
    from bsyolo_tpu_torch.utils.weights import train_state_to_jax

    js = legs["jax"].state
    port_state = train_state_to_jax(legs["port"].state, js)
    payload, meta = jax_load(legs["port"].save_dir / "weights" / "last.ckpt")  # the port's file, JAX's reader
    assert meta["epoch"] == 1 and meta["names"] == ["red", "green", "blue"]
    for field in ("params", "ema_params", "batch_stats"):
        for path, v in _leaves(payload[field]):
            want = dict(_leaves(port_state[field]))[path]
            assert np.asarray(v).dtype == want.dtype and np.abs(np.asarray(v) - want).max(initial=0) == 0
    ts = payload["train_state"]
    assert int(ts["step"]) == port_state["step"] and ts["slot1"] is None and ts["acc_grads"] is None
    assert np.asarray(ts["loss_state"]["iou_mean"]).dtype == np.float32

    payload, meta = load_checkpoint(legs["jax"].save_dir / "weights" / "last.ckpt")  # JAX's file, the port's reader
    for field in ("params", "ema_params", "batch_stats", "slot0"):
        got = dict(_leaves(payload["train_state"][field]))
        for path, want in _leaves(getattr(js, field)):
            assert np.abs(got[path] - np.asarray(want)).max(initial=0) == 0


def test_resume_across_packages(legs, tmp_path):
    """The port resumes the JAX run's last.ckpt at epoch 2; JAX restores the port's full train state."""
    from flax import serialization

    from bsyolo_tpu_torch.engine.trainer import DetectionTrainer
    from bsyolo_tpu_torch.utils.ckpt import load_checkpoint
    from bsyolo_tpu_torch.utils.weights import train_state_to_jax

    project = tmp_path / "runs"
    shutil.copytree(legs["jax"].save_dir, project / "from_jax")
    tr = DetectionTrainer(overrides=dict(COMMON, data=str(legs["data"]), epochs=3, resume=True, device="cpu",
                                         project=str(project), name="from_jax"))
    tr.train()
    assert tr.start_epoch == 2 and tr.state.step == 9
    assert [r["epoch"] for r in _csv(tr.csv_path)] == ["0", "1", "2"]

    payload, meta = load_checkpoint(legs["port"].save_dir / "weights" / "last.ckpt")
    restored = serialization.from_state_dict(legs["jax"].state, payload["train_state"])
    want = train_state_to_jax(legs["port"].state, legs["jax"].state)
    assert int(restored.step) == want["step"] and int(meta["epoch"]) + 1 == 2
    for path, v in _leaves(restored.params):
        assert np.abs(np.asarray(v) - dict(_leaves(want["params"]))[path]).max(initial=0) == 0


def test_facade_loads_a_jax_checkpoint_with_its_class_count(legs):
    """YOLO(<.ckpt of a 3-class run of tiny.yaml>): the port builds the 3-class graph the trainer
    trained; the JAX facade rebuilds tiny.yaml's own 2 classes (ROADMAP queue 3)."""
    from bsyolo_tpu import YOLO as JaxYOLO

    from bsyolo_tpu_torch import YOLO

    best = legs["jax"].save_dir / "weights" / "best.ckpt"
    m = YOLO(best, device="cpu")
    assert m.spec.nc == 3 and m.names == {0: "red", 1: "green", 2: "blue"}
    assert JaxYOLO(str(best)).spec.nc == 2  # the JAX facade's graph does not fit its own checkpoint
    metrics = m.val(data=str(legs["data"]), batch=8, imgsz=64)
    assert set(metrics.results_dict) == set(legs["jax"].metrics.results_dict)
    frames = [np.random.default_rng(0).integers(0, 256, (48, 64, 3), dtype=np.uint8)]
    assert len(m.predict(frames, imgsz=64, conf=0.0001)) == 1


def test_facade_train_val_save_and_callbacks(legs, tmp_path):
    from bsyolo_tpu.engine.trainer import load_checkpoint as jax_load

    from bsyolo_tpu_torch import YOLO

    m = YOLO(TINY, device="cpu")
    seen = []
    m.add_callback("on_fit_epoch_end", lambda t: seen.append(t.epoch))
    m.add_callback("on_train_end", lambda t: seen.append("end"))
    m.clear_callback("on_train_end")
    metrics = m.train(**dict(COMMON, epochs=1, data=str(legs["data"]), project=str(tmp_path), name="facade"))
    assert seen == [0] and m.spec.nc == 3
    for name, p in m.model.named_parameters():  # the trained EMA weights were adopted
        assert np.array_equal(p.detach().numpy(), m.trainer.state.ema_params[name].detach().numpy())
    again = m.val(batch=8)
    np.testing.assert_allclose(list(again.results_dict.values()), list(metrics.results_dict.values()), atol=1e-6)
    out = m.save(tmp_path / "saved.ckpt")
    payload, meta = jax_load(out)
    assert meta["names"] == ["red", "green", "blue"] and "conv" in payload["params"]["m0"]
    reloaded = YOLO(out, device="cpu")
    for (name, a), b in zip(reloaded.model.state_dict().items(), m.model.state_dict().values()):
        if not name.endswith("num_batches_tracked"):  # a torch counter the format has no place for
            assert np.array_equal(a.numpy(), b.numpy()), name
    m.reset_callbacks()
    assert m._callbacks is None


def test_cli_train_val_predict(legs, tmp_path):
    from bsyolo_tpu_torch.cli import main

    data = str(legs["data"])
    args = [f"{k}={v}" for k, v in dict(COMMON, epochs=1, data=data).items()]
    assert main(["train", *args, "device=cpu", f"project={tmp_path}", "name=cli"]) == 0
    best = tmp_path / "cli" / "weights" / "best.ckpt"
    assert best.exists() and len(_csv(tmp_path / "cli" / "results.csv")) == 1
    assert main(["detect", "val", f"model={best}", f"data={data}", "imgsz=64", "batch=8", "device=cpu"]) == 0
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).parents[1]))
    out = subprocess.run([sys.executable, "-m", "bsyolo_tpu_torch", "predict", f"model={best}",
                          f"source={legs['data'].parent / 'images' / 'val'}", "imgsz=64", "conf=0.0001", "device=cpu"],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("6 frames")


@pytest.mark.parametrize("option,item", [
    ({"plots": True}, "item 16"), ({"profile": True}, "item 16"), ({"batch": -1}, "item 16"),
    ({"chunk_steps": 4}, "item 22"),
])
def test_unported_options_raise_naming_their_item(option, item):
    from bsyolo_tpu_torch.engine.trainer import DetectionTrainer

    with pytest.raises(NotImplementedError, match=item):
        DetectionTrainer(overrides=dict(COMMON, data="x.yaml", device="cpu", **option))


@pytest.mark.parametrize("option", [{"amp": True}, {"assigner_bf16": True}], ids=["amp", "assigner_bf16"])
def test_bf16_options_run(option, legs):
    """amp and assigner_bf16, refused until the bf16 graph was ported, set up and take a step."""
    import torch

    from bsyolo_tpu_torch.engine.trainer import DetectionTrainer, to_device
    from bsyolo_tpu_torch.nn.model import compute_dtype

    tr = DetectionTrainer(overrides=dict(COMMON, data=str(legs["data"]), device="cpu", **option))
    tr.setup()
    assert compute_dtype(tr.model) == (torch.bfloat16 if option.get("amp") else torch.float32)
    assert tr.step_cfg.loss.assigner_bf16 == bool(option.get("assigner_bf16"))
    tr.state, m = tr.train_step(tr.state, to_device(next(iter(tr.train_loader)), tr.device))
    assert torch.isfinite(m["loss"]) and m["updated"] == 1


def test_unported_processes_modes_tasks_and_formats_raise(monkeypatch):
    from bsyolo_tpu_torch import YOLO
    from bsyolo_tpu_torch.cli import main
    from bsyolo_tpu_torch.engine.trainer import DetectionTrainer

    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="item 14"):
        DetectionTrainer(overrides=dict(COMMON, data="x.yaml", device="cpu"))
    for argv, item in ((["track"], "item 11"), (["export"], "item 15"), (["segment", "train"], "item 12")):
        with pytest.raises(NotImplementedError, match=item):
            main(argv)
    with pytest.raises(NotImplementedError, match="item 15"):
        YOLO("best.onnx", device="cpu")
    with pytest.raises(NotImplementedError, match="item 20"):
        YOLO(TINY, device="cpu").val(data="x.yaml", save_json=True)


@pytest.mark.parametrize("mode,option,item", [
    ("val", "save_txt=True", "item 20"), ("val", "save_json=True", "item 20"), ("val", "plots=True", "item 20"),
    ("predict", "vid_stride=2", "item 17"), ("predict", "save=True", "item 17"), ("predict", "visualize=True", "item 17"),
    ("predict", "show=True", "item 17"), ("predict", "embed=True", "item 17"),
])
def test_cli_passes_unported_val_and_predict_options_to_the_facade(mode, option, item, tmp_path):
    from bsyolo_tpu_torch.cli import main

    with pytest.raises(NotImplementedError, match=item):
        main([mode, f"model={TINY}", "device=cpu", "data=x.yaml" if mode == "val" else f"source={tmp_path}", option])


@pytest.mark.slow
def test_training_trajectory_matches_jax(tmp_path):
    """The 24-epoch leg of docs/training_parity.md (tiny.yaml at 96 px, 48 train / 16 val
    synthetic images, augmentation off, SGD lr0 0.02, batch 8): the port's final mAP50 within
    0.15 of the JAX trainer's."""
    from test_e2e_train import make_synthetic_dataset
    from test_train_parity import AUG_OFF, HYP

    from bsyolo_tpu.engine.trainer import DetectionTrainer as JaxTrainer

    from bsyolo_tpu_torch.engine.trainer import DetectionTrainer

    data = make_synthetic_dataset(tmp_path / "ds", n_train=48, n_val=16, size=96)
    final = {}
    for name, cls, extra in (("jax", JaxTrainer, {}), ("port", DetectionTrainer, {"device": "cpu"})):
        tr = cls(overrides={"model": TINY, "data": str(data), "epochs": 24, "batch": 8, "imgsz": 96,
                            "optimizer": "SGD", "seed": 3, "max_gt": 32, "amp": False, "close_mosaic": 0,
                            "plots": False, "workers": 0, "project": str(tmp_path / "runs"), "name": name,
                            **HYP, **AUG_OFF, **extra})
        tr.add_callback("on_train_start", lambda t: t.train_loader.dataset.hyp.update(albumentations=0.0))
        final[name] = float(tr.train().box.map50)
    print(f"final mAP50: {final}")
    assert abs(final["port"] - final["jax"]) <= 0.15, final
