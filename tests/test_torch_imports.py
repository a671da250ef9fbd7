"""The port stands alone: no module of bsyolo_tpu_torch, and not chip_smoke.py, imports JAX,
flax, PyYAML, OpenCV, PIL, the onnx packages or anything of the JAX package.

Each check runs in a fresh interpreter whose import system refuses those
packages, imports every module of the port (and loads chip_smoke.py as a
module, without running it), and reports what it could not import. JPEG
files go through the port's own codec (``data/jpeg.py``): the second check
reads and writes one with OpenCV and PIL refused.
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_SCRIPT = r'''
import importlib, importlib.abc, importlib.util, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "flax", "yaml", "cv2", "PIL", "bsyolo_tpu", "onnx", "onnxruntime")

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Refuse())
import bsyolo_tpu_torch
names = ["bsyolo_tpu_torch"] + [m.name for m in pkgutil.walk_packages(bsyolo_tpu_torch.__path__, "bsyolo_tpu_torch.")
                                if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke_module", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print(len(names), leaked)
'''


def test_port_and_chip_smoke_import_nothing_of_jax_yaml_or_opencv():
    """Every module, the JPEG codec's binding and ``utils/coco.py`` among them, with PIL refused too."""
    out = subprocess.run([sys.executable, "-c", _SCRIPT, str(ROOT / "chip_smoke.py")], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    n, leaked = out.stdout.strip().rsplit("\n", 1)[-1].split(" ", 1)
    assert int(n) >= 40 and leaked == "[]", out.stdout


_NO_CV2 = r'''
import importlib.abc, sys
import numpy as np

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("cv2", "PIL", "yaml", "jax", "bsyolo_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Refuse())
from bsyolo_tpu_torch import YOLO
from bsyolo_tpu_torch.app import BlindwaySegmenter, ParkingViolationPipeline
from bsyolo_tpu_torch.trackers import BOTSORT, create_tracker
from bsyolo_tpu_torch.trackers.gmc import GMC
from bsyolo_tpu_torch.data.imread import imread, imwrite

frame = np.full((64, 64, 3), 60, np.uint8)
frame[20:40] = (40, 210, 225)
imwrite(sys.argv[1], frame)
back = imread(sys.argv[1])  # a JPEG round trip at quality 95, no OpenCV or PIL
assert back.shape == frame.shape and np.abs(back.astype(int) - frame).mean() < 4
bot = BOTSORT(with_reid=True, gmc_method="none")
for i in range(3):
    out = bot.update(np.float32([[20 + i, 30, 10, 12], [40, 20 - i, 8, 8]]), np.float32([0.9, 0.8]), np.zeros(2), img=frame)
assert len(out) == 2, out
assert type(create_tracker("bytetrack.yaml")).__name__ == "BYTETracker"
model = YOLO("tests/fixtures/tiny.yaml", device="cpu")
tracked = model.track([frame, frame], imgsz=64, conf=0.0001, tracker="tests/fixtures/trackertest.yaml")
assert tracked[1].boxes.is_track and len(tracked[1])
seg = BlindwaySegmenter(base_c=8, resize=48, device="cpu")
pipe = ParkingViolationPipeline(YOLO("tests/fixtures/tiny.yaml", device="cpu"), seg, conf=0.0001,
                                tracker="tests/fixtures/trackertest.yaml")
pipe.prepare_background(frame)
event, marks = pipe.decide(frame)
assert len(marks) == len(event["tracks"]) > 0
refused = []
for call in (lambda: GMC("sparseOptFlow"), lambda: model.predict("clip.mp4"), lambda: tracked[1].plot(),
             lambda: pipe.render(frame, 0, event, marks), lambda: pipe.run("clip.mp4")):
    try:
        call()
    except ImportError as e:
        refused.append(str(e).split("ROADMAP ")[-1])
print(refused)
'''


def test_product_path_runs_without_opencv_and_its_opencv_calls_name_the_roadmap_item(tmp_path):
    """The tracker (BoT-SORT with ReID, no GMC), YOLO.track, the segmenter and the pipeline's decision
    step run with OpenCV refused; video, GMC's OpenCV estimators, drawing and ``run`` raise ImportError
    naming their ROADMAP item."""
    out = subprocess.run([sys.executable, "-c", _NO_CV2, str(tmp_path / "frame.jpg")], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    refused = out.stdout.strip().rsplit("\n", 1)[-1]
    assert refused == str(["queue 1, item 24", "queue 1, item 24", "queue 1, item 25", "queue 1, item 25",
                           "queue 1, item 24"]), out.stdout


_TASKS = r'''
import importlib.abc, json, sys
from pathlib import Path

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("cv2", "PIL", "yaml", "jax", "jaxlib", "flax", "bsyolo_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Refuse())
sys.path.insert(0, "tests")
from torch_port import write_task_dataset
from bsyolo_tpu_torch import YOLO

root = Path(sys.argv[1])
out = []
for task, graph in (("segment", "tests/fixtures/tinyseg.yaml"), ("pose", "tests/fixtures/tinypose.yaml")):
    data = str(write_task_dataset(root / task, task, n_train=8, n_val=4))
    m = YOLO(graph, device="cpu")
    m.train(data=data, epochs=1, imgsz=64, batch=4, nbs=4, workers=0, amp=False, plots=False,
            project=str(root / "runs"), name=task)
    best = YOLO(str(root / "runs" / task / "weights" / "best.ckpt"), device="cpu")
    metrics = best.val(data=data, batch=4, imgsz=64, save_json=True, save_dir=str(root / "val" / task))
    records = json.loads((root / "val" / task / "predictions.json").read_text())
    r = best.predict(str(root / task / "images" / "val"), imgsz=64, conf=0.001, batch=2,
                     retina_masks=task == "segment")
    payload = r[0].masks if task == "segment" else r[0].keypoints
    out.append((best.task, len(metrics.results_dict), len(records) > 0, "segmentation" in records[0] or
                "keypoints" in records[0], len(r), len(payload) == len(r[0])))
print(out)
'''


def test_segment_and_pose_train_val_predict_without_opencv_pil_or_jax(tmp_path):
    """The Segment and Pose tasks end to end through the facade (polygon fill, task samples, losses,
    validators with save_json, predict with retina_masks) with OpenCV, PIL, PyYAML and JAX refused."""
    out = subprocess.run([sys.executable, "-c", _TASKS, str(tmp_path)], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().rsplit("\n", 1)[-1] == str([("segment", 7, True, True, 4, True),
                                                          ("pose", 5, True, True, 4, True)]), out.stdout


_OBB_CLS = r'''
import importlib.abc, json, sys
from pathlib import Path
import numpy as np

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("cv2", "PIL", "yaml", "jax", "bsyolo_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Refuse())
sys.path.insert(0, "tests")
from torch_port import write_cls_dataset, write_obb_dataset
from bsyolo_tpu_torch import YOLO
from bsyolo_tpu_torch.data.converter import convert_coco
from bsyolo_tpu_torch.data.imread import imwrite
from bsyolo_tpu_torch.data.split_dota import split_trainval

root = Path(sys.argv[1])
out = []
data = str(write_obb_dataset(root / "obb", n_train=8, n_val=4))
m = YOLO("tests/fixtures/tinyobb.yaml", device="cpu")
m.train(data=data, epochs=1, imgsz=64, batch=4, nbs=4, workers=0, amp=False, plots=False, project=str(root / "runs"),
        name="obb")
best = YOLO(str(root / "runs" / "obb" / "weights" / "best.ckpt"), device="cpu")
metrics = best.val(data=data, batch=4, imgsz=64, save_json=True, save_dir=str(root / "val"))
records = json.loads((root / "val" / "predictions.json").read_text())
r = best.predict(str(root / "obb" / "images" / "val"), imgsz=64, conf=0.001, batch=2)
out.append((best.task, len(metrics.results_dict), len(records) > 0 and "poly" in records[0], len(r), r[0].obb is not None))
cls_root = write_cls_dataset(root / "cls", nc=2)
c = YOLO("tests/fixtures/tinycls.yaml", device="cpu")
c.train(data=str(cls_root), epochs=1, imgsz=32, batch=4, nbs=4, workers=0, amp=False, project=str(root / "runs"),
        name="cls")
cbest = YOLO(str(root / "runs" / "cls" / "weights" / "best.ckpt"), device="cpu")
cr = cbest.predict(str(cls_root / "val" / "c0"), imgsz=32)
out.append((cbest.task, len(cbest.val(data=str(cls_root), imgsz=32).results_dict), len(cr), cr[0].probs.data.shape))
dota = root / "dota"
(dota / "images" / "train").mkdir(parents=True)
(dota / "labels" / "train").mkdir(parents=True)
imwrite(dota / "images" / "train" / "P0.jpg", np.full((700, 900, 3), 90, np.uint8))
(dota / "labels" / "train" / "P0.txt").write_text("3 100 100 200 100 200 150 100 150\n")
n = split_trainval(str(dota), str(root / "split"), crop_size=512, gap=100)
(root / "ann.json").write_text(json.dumps({"images": [{"id": 1, "file_name": "a.jpg", "width": 10, "height": 10}],
                                           "annotations": [{"image_id": 1, "category_id": 1, "bbox": [1, 1, 4, 4]}]}))
labels = convert_coco(str(root / "ann.json"), str(root / "conv"))
out.append((n, (labels / "a.txt").read_text()))
print(out)
'''


def test_obb_and_classify_train_val_predict_without_opencv_pil_or_jax(tmp_path):
    """The OBB and Classify tasks end to end through the facade (minimum-area rectangles, RandAugment,
    the classify transforms and loader, both validators, save_json), the DOTA splitter and the COCO
    converter, with OpenCV, PIL, PyYAML and JAX refused."""
    out = subprocess.run([sys.executable, "-c", _OBB_CLS, str(tmp_path)], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().rsplit("\n", 1)[-1] == str([("obb", 5, True, 4, True), ("classify", 3, 2, (2,)),
                                                          (4, "0 0.300000 0.300000 0.400000 0.400000\n")]), out.stdout


_EXPORT = r"""
import importlib.abc, sys
from pathlib import Path
import numpy as np

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("cv2", "PIL", "yaml", "jax", "jaxlib", "flax", "bsyolo_tpu"):
            raise ImportError(f"blocked: {name}")
        return None  # onnx and onnxruntime: torch.export probes for them; neither may be imported

sys.meta_path.insert(0, Refuse())
from bsyolo_tpu_torch import YOLO
from bsyolo_tpu_torch.engine.backend import AutoBackend
from bsyolo_tpu_torch.utils import native

root = Path(sys.argv[1])
m = YOLO("tests/fixtures/tiny.yaml", device="cpu")
x = np.random.default_rng(0).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
outs = []
for fmt in ("pt2", "onnx", "params"):
    path = m.export(format=fmt, imgsz=64, output=str(root / f"t.{fmt}"))
    if fmt != "params":
        outs.append(tuple(AutoBackend(path, device="cpu")(x).shape))
lb, r = native.letterbox(np.zeros((30, 40, 3), np.uint8), (64, 64))
outs.append((lb.shape, round(r, 6)))
outs.append(sorted(n for n in sys.modules if n.split(".")[0] in ("onnx", "onnxruntime")))
print(outs)
"""


def test_export_backend_and_native_run_without_jax_onnx_or_opencv(tmp_path):
    """``pt2``, ``onnx`` and ``params`` exports, their reload through AutoBackend, and the native library's
    binding, with JAX, the onnx packages, OpenCV, PIL and PyYAML refused."""
    out = subprocess.run([sys.executable, "-c", _EXPORT, str(tmp_path)], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().rsplit("\n", 1)[-1] == str([(1, 80, 6), (1, 80, 6), ((64, 64, 3), 1.6), []]), out.stdout
