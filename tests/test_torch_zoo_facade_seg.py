"""yolov8n-seg, a legacy Segment graph, through the PyTorch port's facade against the JAX facade, on the CPU.

As tests/test_torch_zoo_facade.py holds yolov8n (``zoo_port.facade_legs``), at 96 px (the JAX segment loss
takes its 100 mask anchors with ``jax.lax.top_k``): a fitted checkpoint, one epoch of ``YOLO.train`` in each
facade (loss items within 2e-3, params, EMA and BatchNorm statistics within 1e-3 of each tensor's norm, metrics
within 1e-6, box mAP50 above 0.3); ``YOLO.predict`` rows paired with the JAX facade's and each paired row's
mask equal in at least 0.99 of the frame's pixels.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import jax  # noqa: F401
import torch  # noqa: F401

from zoo_port import assert_legs_match, facade_legs, paired_rows

IMG = 96


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    return facade_legs(tmp_path_factory.mktemp("zoo_seg"), "yolov8n-seg.yaml", "segment", IMG, fit_epochs=40)


def test_train_leg_matches_the_jax_facade(legs):
    assert legs["port"].task == "segment" and legs["port"].model.model[-1].legacy
    assert_legs_match(legs, ("box_loss", "seg_loss", "cls_loss", "dfl_loss", "loss"))


def test_predict_rows_and_masks_match_the_jax_facade(legs):
    images = str(Path(legs["data"]).parent / "images" / "train")
    want = legs["jax"].predict(images, imgsz=IMG, conf=0.25, batch=4)
    got = legs["port"].predict(images, imgsz=IMG, conf=0.25, batch=4)
    assert len(got) == len(want) == 8 and sum(len(w) for w in want) >= 8
    for g, w in zip(got, want):
        pairs = paired_rows(g.boxes.data, np.asarray(w.boxes.data))
        assert len(g) == len(w) and len(pairs) == len(w)
        for i, j in pairs:
            assert np.mean(g.masks.data[i] == np.asarray(w.masks.data[j])) >= 0.99
