"""The port stands alone: no module of bsyolo_tpu_torch, and not chip_smoke.py, imports JAX,
flax, PyYAML, OpenCV or anything of the JAX package.

Each check runs in a fresh interpreter whose import system refuses those
packages, imports every module of the port (and loads chip_smoke.py as a
module, without running it), and reports what it could not import. OpenCV is
reached only by the guarded JPEG branch of ``data/imread.py``, which this
never calls.
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_SCRIPT = r'''
import importlib, importlib.abc, importlib.util, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "flax", "yaml", "cv2", "bsyolo_tpu")

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
    out = subprocess.run([sys.executable, "-c", _SCRIPT, str(ROOT / "chip_smoke.py")], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    n, leaked = out.stdout.strip().rsplit("\n", 1)[-1].split(" ", 1)
    assert int(n) >= 40 and leaked == "[]", out.stdout
