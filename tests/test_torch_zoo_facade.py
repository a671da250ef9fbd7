"""yolov8n, a legacy Detect graph, through the PyTorch port's facade against the JAX facade, on the CPU.

``zoo_port.facade_legs``: yolov8n fitted in the port to a seeded 8-image set that is its own validation split,
then one epoch of ``YOLO.train`` in each facade from that checkpoint at 64 px: loss items within 2e-3, params,
EMA and BatchNorm statistics within 1e-3 of each tensor's norm, validation metrics (mAP50 above 0.3) within
1e-6; ``YOLO.val`` and ``YOLO.predict`` of the trained facades against each other (rows paired: class equal,
score within 1e-5, box within 1e-3 px).
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import jax  # noqa: F401
import torch  # noqa: F401

from zoo_port import assert_legs_match, facade_legs, paired_rows

IMG = 64


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    return facade_legs(tmp_path_factory.mktemp("zoo_facade"), "yolov8n.yaml", "detect", IMG, fit_epochs=40)


def test_train_leg_matches_the_jax_facade(legs):
    assert legs["port"].spec.head.module == "Detect" and legs["port"].model.model[-1].legacy
    assert_legs_match(legs, ("box_loss", "cls_loss", "dfl_loss", "loss"))


def test_val_and_predict_match_the_jax_facade(legs):
    got = legs["port"].val(data=str(legs["data"]), batch=4, imgsz=IMG).results_dict
    want = legs["jax"].val(data=str(legs["data"]), batch=4, imgsz=IMG).results_dict
    assert got.keys() == want.keys() and float(want["metrics/mAP50(B)"]) > 0.3
    np.testing.assert_allclose([float(got[k]) for k in want], [float(want[k]) for k in want], rtol=0, atol=1e-6)
    images = str(Path(legs["data"]).parent / "images" / "train")
    want = [np.asarray(r.boxes.data) for r in legs["jax"].predict(images, imgsz=IMG, conf=0.25, batch=4)]
    got = [r.boxes.data for r in legs["port"].predict(images, imgsz=IMG, conf=0.25, batch=4)]
    assert len(got) == len(want) == 8 and sum(len(w) for w in want) >= 8
    for g, w in zip(got, want):
        assert len(g) == len(w) and len(paired_rows(g, w)) == len(w)
