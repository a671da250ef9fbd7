"""The port's checkpoint format (utils/ckpt.py) and tree names (utils/weights.py jax_paths), against flax.

- ``packb`` gives the bytes ``flax.serialization.to_bytes`` gives for nested
  maps of numpy arrays, numpy scalars and Python scalars; ``unpackb`` reads
  flax's bytes back to the same values (exact).
- ``jax_paths`` (the inverse of ``flax_path_to_torch_key``, built from the
  port's module types alone) gives every variable of the JAX graph its JAX
  collection and path, for tiny.yaml, yolo11n and yolo11old (exact).
- ``save_checkpoint`` of a port state is read by the JAX package's
  ``load_checkpoint`` into trees of the JAX graph's structure, shapes and
  dtypes (exact).
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

from torch_port import jax_spec, port_spec, to_plain_dict, variable_shapes  # noqa: E402

TINY = str(Path(__file__).parent / "fixtures" / "tiny.yaml")


def _payload(rng):
    return {
        "params": {"m0": {"conv": {"kernel": rng.normal(size=(3, 3, 3, 16)).astype(np.float32)}},
                   "m1": {"bn": {"scale": rng.normal(size=(70000,)).astype(np.float32)}}},
        "step": np.asarray(41, np.int32),
        "scalar": np.float32(0.5),
        "empty": np.zeros((0, 4), np.uint8),
        "none": None,
        "ints": {"small": 3, "neg": -7, "wide": -70000, "big": 2 ** 40, "u16": 60000},
        "flags": {"t": True, "f": False},
        "text": {"short": "red", "long": "x" * 300},
        "many": {str(i): np.float64(i) for i in range(20)},
        "f": 3.25,
    }


def test_msgpack_bytes_equal_flax(rng):
    from flax import serialization

    from bsyolo_tpu_torch.utils.ckpt import packb, unpackb

    payload = _payload(rng)
    blob = serialization.to_bytes(payload)
    assert packb(payload) == blob
    back = unpackb(blob)
    ref = serialization.msgpack_restore(blob)

    def same(a, b):
        if isinstance(b, dict):
            assert a.keys() == b.keys()
            for k in b:
                same(a[k], b[k])
        else:
            assert type(a) is type(b) and np.array_equal(np.asarray(a), np.asarray(b))
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and a.shape == b.shape

    same(back, ref)


@pytest.mark.parametrize("name", [TINY, "yolo11n.yaml", "yolo11old.yaml"])
def test_jax_paths_invert_flax_path_to_torch_key(name):
    from bsyolo_tpu.nn.model import DetectionGraph

    from bsyolo_tpu_torch.nn.model import build_model
    from bsyolo_tpu_torch.utils.weights import _flatten, flax_path_to_torch_key, jax_paths

    shapes = to_plain_dict(variable_shapes(DetectionGraph(jax_spec(name)), (1, 64, 64, 3)))
    want = {flax_path_to_torch_key(col, path): (col, path) for col, tree in shapes.items() for path, _ in _flatten(tree)}
    assert jax_paths(build_model(port_spec(name), "cpu", 0)) == want


def test_port_checkpoint_has_the_jax_tree_structure(tmp_path):
    import jax

    from bsyolo_tpu.engine.trainer import load_checkpoint as jax_load
    from bsyolo_tpu.nn.model import DetectionGraph

    from bsyolo_tpu_torch.engine.train_step import init_train_state
    from bsyolo_tpu_torch.nn.model import build_model
    from bsyolo_tpu_torch.utils.ckpt import save_checkpoint
    from bsyolo_tpu_torch.utils.weights import jax_paths

    model = build_model(port_spec(TINY), "cpu", 0)
    save_checkpoint(tmp_path / "a.ckpt", init_train_state(model), jax_paths(model), {"epoch": 0}, full=True)
    payload, meta = jax_load(tmp_path / "a.ckpt")
    shapes = to_plain_dict(variable_shapes(DetectionGraph(jax_spec(TINY)), (1, 64, 64, 3)))
    for field, col in (("params", "params"), ("ema_params", "params"), ("batch_stats", "batch_stats")):
        got = jax.tree_util.tree_map(lambda a: (a.shape, a.dtype), payload[field])
        want = jax.tree_util.tree_map(lambda s: (tuple(s.shape), np.dtype(s.dtype)), shapes[col])
        assert got == want, field
    ts = payload["train_state"]
    assert set(ts) == {"step", "params", "batch_stats", "ema_params", "ema_updates", "slot0", "slot1", "acc_grads",
                       "last_opt_step", "loss_state"}
    assert ts["step"].dtype == np.int32 and ts["step"].shape == () and int(ts["last_opt_step"]) == -1
    assert ts["loss_state"]["iou_mean"].dtype == np.float32 and meta == {"epoch": 0}


def test_strip_optimizer_promotes_the_ema(tmp_path):
    from bsyolo_tpu_torch.engine.train_step import init_train_state
    from bsyolo_tpu_torch.nn.model import build_model
    from bsyolo_tpu_torch.utils.ckpt import load_checkpoint, save_checkpoint, strip_optimizer
    from bsyolo_tpu_torch.utils.weights import jax_paths

    model = build_model(port_spec(TINY), "cpu", 0)
    state = init_train_state(model)
    for t in state.ema_params.values():
        t.add_(1.0)
    save_checkpoint(tmp_path / "a.ckpt", state, jax_paths(model), {"epoch": 3}, full=True)
    assert strip_optimizer(tmp_path / "a.ckpt") > 0
    payload, meta = load_checkpoint(tmp_path / "a.ckpt")
    assert meta["stripped"] and "train_state" not in payload and "ema_params" not in payload
    np.testing.assert_array_equal(payload["params"]["m0"]["bn"]["bias"],
                                  state.ema_params["model.0.bn.bias"].numpy())
