"""Export of the PyTorch port (engine/exporter.py) against its live graphs and the JAX package's artifacts.

One tiny graph of each ported family (detect, segment, pose, OBB, classify, v10, RT-DETR, World; tests/
export_port.py) on seeded variables shared by both packages. Gates: a ``pt2`` artifact reloaded through
``AutoBackend`` gives the live port graph's predict outputs exactly (the same ops on the CPU), and the JAX
package's ``stablehlo`` artifact of the same weights within rtol 1e-4 / atol 1e-4 (end-to-end rows as sets,
where near-tied scores may trade places); ``pt2-int8`` equals the live int8 graph and stays within 0.1 of
the float artifact's largest output and above 0 (tests/test_int8.py's bound for ``stablehlo-int8``), and
leaves the graph's int8 mode as it was; the sidecar equals the JAX exporter's on every shared key.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import torch

from export_port import FIXTURES, assert_rows_match, check_pt2_round_trip, family_pair, family_yaml, inputs, jax_export
from torch_port import share_cores

share_cores()

def _np(out):
    return tuple(o.detach().numpy() for o in out) if isinstance(out, tuple) else (out.detach().numpy(),)


def _live(port, x):
    from bsyolo_tpu_torch.engine.exporter import ExportPredict, build_export_predict

    fn, _ = build_export_predict(port.spec, False)
    with torch.no_grad():
        return _np(ExportPredict(port.model.eval(), fn)(torch.from_numpy(x)))


def test_pt2_round_trip_matches_live_graph_and_jax_artifact_rtdetr(tmp_path):
    """The tiny RT-DETR graph's round trip (the other families: tests/test_torch_export_families.py)."""
    check_pt2_round_trip("rtdetr", tmp_path)


def test_sidecar_matches_jax_on_shared_keys(tmp_path):
    jy, port, imgsz = family_pair("segment", tmp_path)
    mine = json.loads(Path(port.export(format="pt2", imgsz=imgsz, output=str(tmp_path / "s.pt2")) + ".json").read_text())
    theirs = json.loads(Path(jax_export(jy, "stablehlo", tmp_path / "s.stablehlo") + ".json").read_text())
    shared = set(mine) & set(theirs)
    assert shared == {"imgsz", "batch", "nc", "names", "task", "nms", "input", "output"}
    assert {k: mine[k] for k in shared} == {k: theirs[k] for k in shared}
    assert mine["input"] == "NHWC float32 [0,1] RGB"


def test_pt2_int8_matches_live_int8_graph_within_the_int8_bound(tmp_path):
    from bsyolo_tpu_torch.engine.backend import AutoBackend
    from bsyolo_tpu_torch.nn.modules import int8_inference, set_int8_inference
    from bsyolo_tpu_torch.nn.quant import calibrate_int8

    _, port, imgsz = family_pair("detect", tmp_path)
    x = inputs(imgsz, 1, seed=3)
    p_f = port.export(format="pt2", imgsz=imgsz, output=str(tmp_path / "t.pt2"))
    p_8 = port.export(format="pt2-int8", imgsz=imgsz, output=str(tmp_path / "t.pt2-int8"))
    assert not int8_inference(port.model)  # export restores the graph's mode
    meta = json.loads(Path(p_8 + ".json").read_text())
    assert meta["quant"] == "int8 convs, per-out-channel weight + static activation scales"
    b8 = AutoBackend(p_8, device="cpu")
    assert "bsyolo.int8_matmul.default" in {str(n.target) for n in b8.program.graph.nodes}
    y_f, y_8 = AutoBackend(p_f, device="cpu")(x).numpy(), b8(x).numpy()
    rel = float(np.max(np.abs(y_f - y_8)) / (np.max(np.abs(y_f)) + 1e-9))
    assert 0 < rel < 0.1, rel
    # the live int8 graph under the exporter's calibration (four uniform batches, seed 0)
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(rng.uniform(0, 1, (1, imgsz, imgsz, 3)).astype(np.float32)).permute(0, 3, 1, 2)
               .contiguous() for _ in range(4)]
    set_int8_inference(port.model, True, calibrate_int8(port.model, batches))
    live = _live(port, x)[0]
    set_int8_inference(port.model, False)
    np.testing.assert_array_equal(y_8, live)


def test_pt2_int8_keeps_a_preset_int8_mode(tmp_path):
    from bsyolo_tpu_torch.nn.modules import Conv, int8_inference, set_int8_inference

    _, port, imgsz = family_pair("detect", tmp_path)
    set_int8_inference(port.model, True, {"model.0.conv": 2.0})
    port.export(format="pt2-int8", imgsz=imgsz, output=str(tmp_path / "t.pt2-int8"))
    assert int8_inference(port.model)
    first = port.model.model[0]
    assert isinstance(first, Conv) and first.act_absmax == 2.0 and not first.int8_frozen


def test_int8_conv_keeps_one_prepared_weight_across_requantizations():
    """The eager int8 conv keeps one Int8Weight, on itself: each re-quantization (the weight changed in
    place, or the mode set again) replaces it, the old ones are freed, and the output follows the weight."""
    import gc

    from bsyolo_tpu_torch.kernels.int8_matmul import Int8Weight
    from bsyolo_tpu_torch.nn.modules import Conv, set_int8_inference

    def live_weights():
        gc.collect()
        return sum(type(o) is Int8Weight for o in gc.get_objects())

    torch.manual_seed(0)
    conv = Conv(8, 16, 3, 1).eval()
    x = torch.rand(2, 8, 12, 12)
    base = live_weights()
    for i in range(6):
        with torch.no_grad():
            if i % 2:
                conv.conv.weight.mul_(1.5)
            else:
                set_int8_inference(conv, True, {"conv": 2.0 + i})
            got = conv(x)
        fresh = Conv(8, 16, 3, 1).eval()
        fresh.load_state_dict(conv.state_dict())
        set_int8_inference(fresh, True, {"conv": conv.act_absmax})
        with torch.no_grad():
            assert torch.equal(got, fresh(x))
        del fresh
        assert live_weights() == base + 1, i


def test_operator_weight_lives_with_the_tensor_it_reads():
    """bsyolo::int8_matmul's prepared weight is kept on the tensor that owns the codes' storage: the same
    object for another view of it, a new one once the codes change in place, and freed with the owner."""
    import gc
    import weakref

    from bsyolo_tpu_torch.kernels.int8_matmul import (empty_rows, int8_matmul_prepared, int8_matmul_reference,
                                                      prepared_weight)

    owner = empty_rows(16, 20, "cpu")._base
    owner.copy_(torch.randint(-127, 128, owner.shape, dtype=torch.int8, generator=torch.Generator().manual_seed(1)))
    sw, sx = torch.rand(16), torch.tensor(0.05)
    x = torch.randint(-127, 128, (7, 20), dtype=torch.int8, generator=torch.Generator().manual_seed(2))
    first = prepared_weight(owner[:, :20].t(), sw)
    assert prepared_weight(owner[:, :20].t(), sw) is first
    owner[0, 0] += 1
    again = prepared_weight(owner[:, :20].t(), sw)
    assert again is not first
    assert torch.equal(int8_matmul_prepared(x, again, sx), int8_matmul_reference(x, owner[:, :20].t(), sw, sx))
    kept = weakref.ref(again)
    del owner, first, again
    gc.collect()
    assert kept() is None


@pytest.mark.parametrize("fmt,error,match", [
    ("stablehlo", ValueError, "pt2"), ("stablehlo-int8", ValueError, "pt2-int8"),
    ("saved_model", RuntimeError, "requires tensorflow"), ("tflite", RuntimeError, "requires tensorflow"),
    ("engine", ValueError, "unsupported export format"),
])
def test_formats_other_machines_serve_raise(fmt, error, match):
    from bsyolo_tpu_torch import YOLO

    port = YOLO(str(FIXTURES / "tiny.yaml"), device="cpu")
    with pytest.raises(error, match=match):
        port.export(format=fmt, imgsz=64)


@pytest.mark.parametrize("family", ["segment", "pose", "obb", "classify", "v10", "rtdetr"])
def test_nms_export_refused_off_the_plain_detect_head(family, tmp_path):
    from bsyolo_tpu.engine.exporter import _build_export_predict
    from bsyolo_tpu.nn import load_model_yaml, parse_model_yaml
    from bsyolo_tpu_torch import YOLO

    path = family_yaml(family, tmp_path)
    port = YOLO(path, device="cpu")
    with pytest.raises(ValueError) as perr:
        port.export(format="pt2", imgsz=64, nms=True)
    d = load_model_yaml(path)
    with pytest.raises(ValueError) as jerr:
        _build_export_predict(parse_model_yaml(d, scale=d.get("scale", "")), None, None, True)
    assert str(perr.value) == str(jerr.value)


def test_params_export_reloads(tmp_path):
    from bsyolo_tpu_torch import YOLO

    _, port, imgsz = family_pair("detect", tmp_path)
    ckpt = port.export(format="params", output=str(tmp_path / "w.params"))
    assert ckpt.endswith(".ckpt")
    back = YOLO(ckpt, device="cpu")
    for (k, a), b in zip(port.model.state_dict().items(), back.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


def test_pt2_nms_rows_match_jax(tmp_path):
    """``nms=True`` on Detect: the exported greedy NMS (a while_loop) keeps JAX's rows."""
    from bsyolo_tpu.engine.exporter import load_stablehlo
    from bsyolo_tpu_torch.engine.backend import AutoBackend

    jy, port, imgsz = family_pair("detect", tmp_path, seed=4)
    x = inputs(imgsz, 2, seed=5)
    art = port.export(format="pt2", imgsz=imgsz, batch=2, nms=True, output=str(tmp_path / "n.pt2"))
    got = AutoBackend(art, device="cpu")(x).numpy()
    assert got.shape == (2, 300, 6) and (got[..., 4] > 0).any()
    want = np.asarray(load_stablehlo(jax_export(jy, "stablehlo", tmp_path / "n.stablehlo", batch=2, nms=True))(x))
    assert_rows_match(got, want, rtol=1e-4, atol=1e-4)
